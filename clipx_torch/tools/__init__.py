"""Command-line tools of the port (``python -m clipx_torch.tools.<name>``),
counterparts of the root ``tools/`` scripts that run clipx's modules."""
