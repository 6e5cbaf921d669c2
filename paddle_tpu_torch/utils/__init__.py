"""Small helpers of the port (``paddle_tpu/utils``): the dataset home."""
