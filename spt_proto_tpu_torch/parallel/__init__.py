"""Tensor- and data-parallel serving over torch.distributed (port of
spt_proto_tpu/parallel, the serving mesh): mesh.py (the ('data', 'model')
mesh and the process group), comm.py (the collectives), sharding.py (the
parameter rules), infer_sharding.py (a rank's shard of the serving weights
and caches) and launch.py (a world of local processes)."""
