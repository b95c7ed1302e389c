"""Entry points of the port: the serving driver (`serve`), the training
driver (`train`), meshes (`mesh`), the sharding rules and the sharded
parameter layout (`shardings`) and GPipe (`pipeline`)."""
