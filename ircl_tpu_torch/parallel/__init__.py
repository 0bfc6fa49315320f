"""Device mesh, rank launcher, and the corpus- and data-parallel paths.

Counterpart of ``ircl_tpu/parallel/`` (its data and corpus halves: ``mesh``,
``common``, ``sharded_index``, ``sharded_hybrid``, ``dp``). The reference is
one process that sees every device; the port runs one process per device
(``launch.py`` or ``torchrun``), each holding its shard, and every function
returns on every rank what the reference returns: the merged, replicated
result.
"""

from ircl_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
