"""The training step, and running over several devices: the mesh (one process a device), the
data-parallel steps and the H-sharded (spatial) forward."""
