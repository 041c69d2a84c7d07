"""Multi-device layouts of the radar frame on torch.distributed
(counterpart of radarays_ros_tpu/parallel/): meshes and their process
groups (groups.py), the layouts and the sharded training step
(sharding.py), spawning ranks (launch.py) and the dry run (dryrun.py)."""
