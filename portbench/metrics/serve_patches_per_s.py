"""Patches of the tiles whose maps reached the host inside the window, over
the window's seconds."""
from portbench.harness.readers import rate as read  # noqa: F401
