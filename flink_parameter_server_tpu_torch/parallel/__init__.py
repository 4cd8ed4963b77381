"""Parallelism across devices: the ``dp × ps`` mesh, its collectives and
multi-host launch.

Counterpart of ``flink_parameter_server_tpu/parallel/``.  The design:

* **One process per device.**  The reference is single-controller: one
  process drives every device through ``shard_map``.  The port runs one
  rank per device under ``torch.distributed`` (NCCL on ``cuda``, gloo on
  ``cpu``), the fabric of the LM's data, expert, tensor, sequence and
  pipeline parallelism too.  Each rank runs what the ``shard_map`` body runs:
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
* **Collectives take what both torch 2.11 and 2.13 have**: the list forms
  of ``all_gather`` and ``reduce_scatter``, ``all_reduce``, and
  ``all_to_all_single`` (torch 2.11's gloo refuses the list
  ``all_to_all``).  gloo also
  takes ``cuda`` tensors (staged through the host), which is how more
  ranks than cards share one card.

**Two execution models.**

* **The dense LM: one rank a device**, the fabric above, on a ``("dp",)``
  mesh (:func:`.mesh.make_dp_mesh`) or ``(dp, ps)`` with ps 1.  Every rank
  reads the same global microbatch and trains on its contiguous rows
  (:func:`.collectives.dp_rows`); the gradients are summed with an
  all-reduce (replicated) or a reduce-scatter plus an all-gather of the
  updated slices (ZeRO-1, FSDP: ``core/dense.py``).  A loss whose
  normalisation depends on the rows (the LM's count of valid tokens) is
  the whole batch's through :func:`.collectives.global_mean`.  The flash
  kernels run on each rank's rows (``ops/flash_attention.flash_mha_dp``).
* **The mesh store: one process, n row blocks.**  The reference's
  ``MeshParamStore`` is single-controller, and so is the port's
  (``meshstore/``): the cluster driver's one process holds block ``i`` on
  ``devices[i]``, with no process group at all.

**Expert parallelism** runs on the LM's fabric: a ``("dp", "ep")`` mesh
(``make_mesh(dp, ep, axis_names=("dp", "ep"))``), each rank holding its
dp rows and ``E/ep`` experts of every MoE layer, the tokens routed to their
expert's rank and back by two :func:`.collectives.all_to_all` trips over
``ep`` (``models/moe.moe_apply``); gradients are summed over dp only.

**Tensor, sequence and pipeline parallelism** run on the same fabric, on
meshes of any number of axes (:func:`.mesh.make_nd_mesh`):

* tp: Megatron's column- and row-parallel products around the conjugate
  pair :func:`.collectives.copy_to_tp` / :func:`.collectives.reduce_from_tp`
  (``models/transformer.py``); the flash kernels run on each rank's heads.
* sp: :mod:`.ring_attention`, ``S − 1`` :func:`.collectives.ppermute`
  trips of the K/V blocks around the sp ring under an online softmax.
* pp: :mod:`.pipeline`, the GPipe tick schedule with one ``ppermute`` a
  tick, its backward the reverse schedule.

``ppermute`` rides ``all_to_all_single`` with one non-empty split each way,
so it runs on NCCL and on gloo over CUDA tensors alike.
"""
from .collectives import (
    all_gather_cat,
    all_reduce_sum,
    all_to_all,
    copy_to_tp,
    dp_rows,
    global_mean,
    ppermute,
    reduce_from_tp,
    reduce_scatter_sum,
    shard_pull,
    shard_push_add,
)
from .mesh import DP_AXIS, PS_AXIS, make_dp_mesh, make_mesh, make_nd_mesh, single_device_mesh
from .multihost import initialize, make_multihost_mesh, process_local_batch_slice

__all__ = [
    "DP_AXIS",
    "PS_AXIS",
    "all_gather_cat",
    "all_reduce_sum",
    "all_to_all",
    "copy_to_tp",
    "dp_rows",
    "global_mean",
    "initialize",
    "make_dp_mesh",
    "make_mesh",
    "make_multihost_mesh",
    "make_nd_mesh",
    "ppermute",
    "process_local_batch_slice",
    "reduce_from_tp",
    "reduce_scatter_sum",
    "shard_pull",
    "shard_push_add",
    "single_device_mesh",
]
