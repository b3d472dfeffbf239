"""Walker-mesh sharding over ``torch.distributed`` ranks (``mesh``)."""
