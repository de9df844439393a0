"""utils (PyTorch port of weiner_slamit_v2_tpu/utils): timing, tracing, sensor fusion."""
