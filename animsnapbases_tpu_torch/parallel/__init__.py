"""Multi-GPU stepping and bases on ``torch.distributed``.

Counterpart of ``animsnapbases_tpu/parallel``.  Every sharded function
takes a ``torch.distributed.device_mesh.DeviceMesh`` with named axes where
the JAX function takes a ``jax.sharding.Mesh``; every rank of the mesh
calls it (SPMD).  The scaling axes:

* ensemble data parallelism: a batch of independent sims split over a
  mesh axis, no collective in the step (``make_ensemble_step``, and
  ``make_batched_run`` / ``make_batched_step`` with ``mesh=`` on the
  batched kernels);
* element sharding: a sim's constraint elements split over an axis, the
  right-hand side one ``all_reduce`` an iteration
  (``make_element_sharded_step``);
* tensor-parallel reduced stepping: the hyper-reduced solver's selected
  elements and vertex axis split over the mesh (``make_tp_reduced_step``);
* sharded bases: the snapshot POD's Gram product as an ``all_reduce``
  (``ops/podlinalg.py::snapshot_pod_sharded``), and the DEIM scans and
  the greedy position bases with their row or vertex axis split
  (``mesh=``).
"""

from animsnapbases_tpu_torch.parallel.ensemble import (  # noqa: F401
    build_device_mesh,
    make_element_sharded_step,
    make_ensemble_step,
    mesh_from_shards,
)
from animsnapbases_tpu_torch.parallel.reduced_tp import (  # noqa: F401
    make_tp_reduced_step,
)
