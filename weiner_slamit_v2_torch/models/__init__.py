"""models (PyTorch port of weiner_slamit_v2_tpu/models): the PoseNet head."""
