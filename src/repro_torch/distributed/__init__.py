"""Tensor-parallel serving over ``torch.distributed``: ``tp`` (the step
context, the per-shard config, the weight shards, the collectives) and
``sharding`` (how the pool state shards)."""
