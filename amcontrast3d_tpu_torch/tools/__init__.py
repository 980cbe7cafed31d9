"""Command-line tools that run the port on a CUDA device."""
