"""Entry points of the port: serving (``serve``), training (``train``)
and the step functions they run (``steps``); distribution: device
meshes (``mesh``), sharding rules (``shard_rules``) and the multi-pod
dry run (``dryrun``)."""
