"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: its serve path
on published model widths, driven by the files in this folder.  See
README.md; ``run.py`` is the command."""
