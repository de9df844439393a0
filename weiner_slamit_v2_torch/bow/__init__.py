"""bow (PyTorch port of weiner_slamit_v2_tpu/bow): vocabulary and keyframe database."""
