"""The benchmark of the PyTorch/CUDA port (``nobs_whisper_torch``): one
command runs one cell once (``benchmark/run.py``)."""
