"""See the package docstring of fitslam_tpu_torch."""
