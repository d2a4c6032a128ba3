"""Parallelism: the device mesh, the logical-axis sharding rules that bind
the model to it, and the differentiable collectives of the sharded step."""
