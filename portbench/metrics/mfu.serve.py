"""Model FLOPs of a patch's forward (the plain reference's convolutions and
matrix products at the cell's shapes) times the patches of the traced
stretch over its seconds, as a share of the card's dense peak."""
from portbench.harness.readers import mfu as read  # noqa: F401
