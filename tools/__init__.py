"""Scripts and shared inputs of the PyTorch port (``tools/inputs.py``,
``tools/time_kernels.py``)."""
