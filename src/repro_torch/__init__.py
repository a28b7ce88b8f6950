"""PyTorch port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``repro``'s module layout (``models/attention.py``
is the counterpart of ``repro/models/attention.py``, and so on).  The
attention of the paged serving path runs through hand-written CUDA
kernels under ``kernels/``; everything else is plain PyTorch.  Entry
points run on ``cuda`` unless the caller asks for ``device="cpu"``.
"""
