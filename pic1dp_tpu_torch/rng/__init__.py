"""Random number generation: the multirand-compatible engines (the marker
loader's deterministic backend).  The default backend draws from a
torch.Generator in core/loading.py."""
