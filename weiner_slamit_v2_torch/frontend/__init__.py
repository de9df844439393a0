"""frontend (PyTorch port of weiner_slamit_v2_tpu/frontend)."""
