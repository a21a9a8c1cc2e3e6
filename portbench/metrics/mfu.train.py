"""Model FLOPs of a sample's forward and backward (the plain reference's
convolutions and matrix products at the cell's shapes; recompute not
counted) times the samples of the traced stretch over its seconds, as a
share of the card's dense peak."""
from portbench.harness.readers import mfu as read  # noqa: F401
