"""Parallelism across devices: the ``dp × ps`` mesh, its collectives and
multi-host launch.

Counterpart of ``flink_parameter_server_tpu/parallel/``.  The design:

* **One process per device.**  The reference is single-controller: one
  process drives every device through ``shard_map``.  The port runs one
  rank per device under ``torch.distributed`` (NCCL on ``cuda``, gloo on
  ``cpu``), the fabric the LM's data, tensor and pipeline parallelism
  will need too.  Each rank runs what the ``shard_map`` body runs:
  ``mesh.get_local_rank("ps")`` plays ``axis_index``, an ``all_reduce``
  on the ``ps`` group plays ``psum``, and an ``all_gather`` on the ``dp``
  group plays ``all_gather(tiled=True)`` (:mod:`.collectives`).
* **The mesh** is a ``DeviceMesh`` with axes ``("dp", "ps")``
  (:func:`.mesh.make_mesh`): global rank ``d * ps + p`` is worker slice
  ``d`` and table shard ``p``.
* **What a rank holds.**  A sharded store keeps only its row block
  ``[p·R, (p+1)·R)``, replicated over ``dp``; ``values()`` gathers the
  whole table on every rank.  Every rank reads the same global
  microbatch, as the reference's one controller does; a ``dp`` axis
  splits it into contiguous slices, and the step exchanges the slices'
  requests with one all-gather over ``dp``, and its per-record outputs
  only when something reads them.  Worker state (MF's user table) is
  replicated and updated from the dp all-gather of the user deltas, so it
  keeps the global lane order; ``dedup_scale`` counts duplicates over the
  all-gathered ids of every slice (``ops/dedup.occurrence_scale(mesh=)``).
* **One owned-rows rule.**  Every sharded pull and push (the store's, the
  locality MF step's, the fused sharded step's, the sharded top-K's)
  takes its block's ids from :func:`.collectives.owned_rows` and
  assembles a pull with :func:`.collectives.assemble_owned`.
* **Collectives take what both torch 2.11 and 2.13 have**: the list form
  of ``all_gather`` and ``all_reduce``.  gloo also takes ``cuda`` tensors
  (staged through the host), which is how more ranks than cards share
  one card.

The LM's half (data-parallel allreduce, ZeRO-1, FSDP, expert parallelism,
ring attention, tensor parallelism and the pipeline) is still to come
(ROADMAP Queue 1 #9): ``ring_attention`` holds only the unsharded oracle.
"""
from .collectives import all_gather_cat, all_reduce_sum, shard_pull, shard_push_add
from .mesh import DP_AXIS, PS_AXIS, make_mesh, single_device_mesh
from .multihost import initialize, make_multihost_mesh, process_local_batch_slice

__all__ = [
    "DP_AXIS",
    "PS_AXIS",
    "all_gather_cat",
    "all_reduce_sum",
    "initialize",
    "make_mesh",
    "make_multihost_mesh",
    "process_local_batch_slice",
    "shard_pull",
    "shard_push_add",
    "single_device_mesh",
]
