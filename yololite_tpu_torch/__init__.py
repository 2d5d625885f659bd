"""PyTorch/CUDA port of yololite_tpu (H100). See README "PyTorch port"."""
