"""The port's data path: numpy copies of the JAX package's host-side data
code (``splits``, ``kitti_utils``, ``kitti``, ``sequence``, ``synthetic``,
``pipeline``) and the device-side preprocessing (``transforms``)."""
