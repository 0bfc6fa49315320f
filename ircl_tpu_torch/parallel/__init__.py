"""Device mesh, rank launcher, and the data, corpus, tensor and expert
parallel paths.

Counterpart of ``ircl_tpu/parallel/``: ``mesh``, ``common``,
``sharded_index``, ``sharded_hybrid`` and ``dp`` (data and corpus
parallelism), ``tp`` (tensor parallelism with sequence parallelism) and
``ep`` (expert parallelism). The reference is one process that sees every
device; the port runs one process per device (``launch.py`` or
``torchrun``), each holding its shard, and every function returns on every
rank what the reference returns. Pipeline and context parallelism (``pp``,
``cp``) are not ported yet (ROADMAP.md queue 1 item 12).
"""

from ircl_tpu_torch.parallel.ep import make_ep_mesh, make_ep_tp_mesh
from ircl_tpu_torch.parallel.mesh import make_mesh
from ircl_tpu_torch.parallel.tp import make_tp_mesh

__all__ = ["make_ep_mesh", "make_ep_tp_mesh", "make_mesh", "make_tp_mesh"]
