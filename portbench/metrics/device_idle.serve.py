"""The share of the traced stretch in which no operation ran on the card."""
from portbench.harness.readers import idle_share as read  # noqa: F401
