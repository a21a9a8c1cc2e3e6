"""Samples of the steps run inside the window, over the window's seconds
(the window ends in a synchronize)."""
from portbench.harness.readers import rate as read  # noqa: F401
