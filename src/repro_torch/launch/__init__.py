"""Process meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``), their collectives and a rank spawner."""
