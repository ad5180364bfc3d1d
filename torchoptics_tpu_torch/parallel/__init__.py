"""Data parallelism over (lens, rays) on ``torch.distributed``: the process
mesh and its collectives (``mesh``), the sharded trace, loss and training
step (``shard``)."""
