"""Command-line tools of the port (``python -m clipx_torch.tools.<name>``),
counterparts of the root ``tools/`` scripts that run clipx's modules:
``build_codes_direct``, ``convert_checkpoint``, ``eval_quality``,
``find_dupes``, ``kv_tool``, ``load_timing``, ``make_synth_index`` and
``parity_check`` (the real-weight parity gate)."""
