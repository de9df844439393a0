"""slam_map (PyTorch port of weiner_slamit_v2_tpu/slam_map)."""
