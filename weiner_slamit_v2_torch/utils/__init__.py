"""utils (PyTorch port of weiner_slamit_v2_tpu/utils): the span recorder, sensor fusion."""
