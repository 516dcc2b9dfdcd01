"""Dynamic graphs: edge mutations, epoch-versioned slabs and incremental
walk-index refresh (port of ``repro/dynamic``).

* :mod:`repro_torch.dynamic.mutations` — batched edge inserts and deletes
  compacted on the host into a new CSR per epoch (``CSRGraph.epoch`` /
  ``mutation_offset`` are the provenance graphs and slab manifests
  carry), placed on the old graph's device;
* :mod:`repro_torch.dynamic.refresh` — per-segment invalidation from the
  build's ``visited_blocks`` masks on the index's device, and an
  incremental re-walk of the stale rows through the index build's segment
  walk (the ``frog_segment_walk`` kernel, masks recorded in it), writing back
  exactly the stale cells; epoch'd checkpoint directories;
* :meth:`repro_torch.FrogWildService.apply_mutations` — the two-epoch
  commit that swaps slabs without stopping admission.

**The staleness/epoch contract.**

1. *Epochs are immutable snapshots.* A :class:`MutationBatch` never
   modifies an existing ``CSRGraph`` or slab; it produces new ones at
   ``epoch + 1``. A slab is valid for one graph epoch
   (``WalkIndex.graph_epoch``), and loaders refuse mismatched pairs.
2. *Invalidation is sound, possibly conservative.* A segment not marked
   stale is byte-identical under the new graph; block granularity
   (``segment_mask_block_size``) can only over-invalidate.
3. *Refresh equals rebuild.* ``refresh_walk_index`` walks only the rows
   holding stale segments and writes back only the stale cells, yet
   returns a slab byte-equal (endpoints and masks) to a from-scratch
   build at the new epoch.
4. *Serving never stops.* In-flight queries pin the epoch (scheduler and
   slab) they were admitted on and finish byte-identically to a run in
   which no mutation happened; new admissions land on ``e + 1``; the old
   epoch's scheduler is released when its last pinned query settles.
"""
from repro_torch.dynamic.mutations import (MutationBatch, MutationLog,
                                           apply_mutations)
from repro_torch.dynamic.refresh import (RefreshReport, dirty_block_mask,
                                         epoch_dir, invalidate_segments,
                                         list_epochs, load_epoch_index,
                                         refresh_walk_index,
                                         save_epoch_index)

__all__ = [
    "MutationBatch",
    "MutationLog",
    "RefreshReport",
    "apply_mutations",
    "dirty_block_mask",
    "epoch_dir",
    "invalidate_segments",
    "list_epochs",
    "load_epoch_index",
    "refresh_walk_index",
    "save_epoch_index",
]
