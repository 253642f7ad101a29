"""Data-parallel training and sharded evaluation across GPUs: the port's
counterpart of hipie_tpu/parallel/ (``mesh``, ``multihost``) and of
``__graft_entry__.dryrun_multichip`` (``dryrun``)."""
