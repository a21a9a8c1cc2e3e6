"""Host milliseconds a patch of a tile's call less its fetch, which waits
for the card (the spans ``tile.predict`` less ``tile.fetch``, over the
program's ``tile.patches``): the host's cost to issue a tile, to be set
beside 1000 / ``serve_patches_per_s``."""
from portbench.harness import spans


def read(r):
    return spans.host_ms(r, ("tile.predict",), "tile.patches", less=("tile.fetch",))
