"""Scale-out over torch.distributed: the (data, camera) process mesh, shards and the
sequence scans (port of m3t_tpu/parallel)."""

from m3t_tpu_torch.parallel.sharding import (
    Mesh,
    initialize_distributed,
    make_mesh,
    shard_over,
    track_sequences_scan,
    track_sequences_scan_rgbd,
)

__all__ = ["Mesh", "initialize_distributed", "make_mesh", "shard_over",
           "track_sequences_scan", "track_sequences_scan_rgbd"]
