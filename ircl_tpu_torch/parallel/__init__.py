"""Device mesh, rank launcher, and the data, corpus, tensor, expert, pipeline
and context parallel paths.

Counterpart of ``ircl_tpu/parallel/``: ``mesh``, ``common``,
``sharded_index``, ``sharded_hybrid`` and ``dp`` (data and corpus
parallelism), ``tp`` (tensor parallelism with sequence parallelism), ``ep``
(expert parallelism), ``pp`` (the GPipe pipeline, its reverse written by
hand) and ``cp`` (context parallelism over ``ops/ring_attention.py``). The
reference is one process that sees every device; the port runs one process
per device (``launch.py`` or ``torchrun``), each holding its shard, and
every function returns on every rank what the reference returns.
``make_pp_mesh`` and ``make_cp_mesh`` load on first use: ``pp`` and ``cp``
import the models, which import this package.
"""

from ircl_tpu_torch.parallel.ep import make_ep_mesh, make_ep_tp_mesh
from ircl_tpu_torch.parallel.mesh import make_mesh
from ircl_tpu_torch.parallel.tp import make_tp_mesh


def __getattr__(name):
    if name == "make_pp_mesh":
        from ircl_tpu_torch.parallel.pp import make_pp_mesh

        return make_pp_mesh
    if name == "make_cp_mesh":
        from ircl_tpu_torch.parallel.cp import make_cp_mesh

        return make_cp_mesh
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = ["make_cp_mesh", "make_ep_mesh", "make_ep_tp_mesh", "make_mesh", "make_pp_mesh",
           "make_tp_mesh"]
