"""parallel (PyTorch port of weiner_slamit_v2_tpu/parallel): distributed BA, data-parallel
extraction."""
