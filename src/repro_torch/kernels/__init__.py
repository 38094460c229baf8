"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``csrc/transcode.cu`` holds the transcode kernels (count, write and
one-pass, flat and packed) and the legacy validate, decode and encode
kernels; ``csrc/flash_attention.cu`` the flash attention kernel;
``csrc/windowed.cu`` the windowed strategy's two one-warp walks (their
wrappers live in ``core/windowed.py``).  Each
wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor, and counts its launches (``<wrapper>.launches``).
"""
