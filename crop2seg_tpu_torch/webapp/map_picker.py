"""Czech-Republic Sentinel-2 grid picker: WGS84 point -> (tile, cell).

The reference renders the CZ Sentinel-2 grid on a leafmap slippy map and
spatial-joins map clicks (WGS84) to a grid cell with geopandas
(reference src/webapp/home.py:13-77 over ``get_s2_grid``,
get_data.py:82-110: the 12 T33 tiles partitioned into 10x10 cells). This
module does the same join in closed form — no geopandas/leafmap/shapely:

- :data:`CZ_TILES`: the reference's 12 tile names (get_data.py:91-92).
- :func:`pick_patch`: WGS84 (lat, lon) -> {'tile', 'cell', 'bounds', 'crs'}
  via the pure-math WGS84->UTM33 transform + point-in-cell arithmetic;
  overlapping tile footprints (S2 tiles overlap ~9.8 km) disambiguate to
  the tile whose centre is nearest, which is deterministic where the
  reference's ``sjoin(...).values[0]`` depends on row order.
- :func:`cz_grid_map_html`: a SELF-CONTAINED interactive map (inline SVG +
  ~40 lines of vanilla JS: pan, wheel zoom, hover ids, click-to-select
  writing ``tile:cell`` into the status line and ``location.hash``). Works
  standalone in any browser and embeds in the Streamlit shell via
  ``st.components.v1.html`` — zero network/tile/JS dependencies, so it
  renders without network access.

Tile corners come from the authoritative Sentinel-2 shapefile index when
``index_path`` is given (the file the reference clones) and otherwise from
the MGRS 100-km grid-square approximation (see
``pipeline.mgrs_tile_origin``).
"""
from __future__ import annotations

import html as _html
from typing import Dict, Optional, Tuple

# Reference get_data.py:91-92 (the tiles covering the Czech Republic)
CZ_TILES = ("T33UVS", "T33UWS", "T33UUR", "T33UVR", "T33UWR", "T33UXR",
            "T33UYR", "T33UUQ", "T33UVQ", "T33UWQ", "T33UXQ", "T33UYQ")
TILE_M = 109800.0      # S2 tile edge (10980 px @ 10 m)
UTM_ZONE = 33


def cz_tile_origins(index_path: Optional[str] = None
                    ) -> Dict[str, Tuple[float, float]]:
    """Upper-left UTM-33N corner per CZ tile (index-authoritative when
    available, MGRS approximation otherwise)."""
    from crop2seg_tpu_torch.webapp.pipeline import (
        mgrs_tile_origin, tile_origin_from_index)

    out = {}
    for name in CZ_TILES:
        origin = None
        if index_path is not None:
            # Any unreadable/corrupt index (missing file, truncated or
            # non-shapefile bytes -> struct.error/ValueError from the
            # header parser, tile absent) falls back to the MGRS origin:
            # a bogus index path must degrade the origins, not crash the
            # Home page render.
            try:
                origin = tile_origin_from_index(name, index_path)
            except Exception:
                origin = None
        out[name] = origin if origin is not None else mgrs_tile_origin(name)
    return out


def pick_patch(lat: float, lon: float,
               index_path: Optional[str] = None) -> Dict:
    """WGS84 click -> picked cell dict (reference home.py:63-77 +
    get_data.get_info:176-185). Raises ValueError outside every CZ tile."""
    from crop2seg_tpu_torch.gis.geo import wgs84_to_utm
    from crop2seg_tpu_torch.webapp.pipeline import cell_from_xy, tile_cell_bounds

    e, n = wgs84_to_utm(lon, lat, UTM_ZONE)
    e, n = float(e), float(n)
    best = None
    for name, (ulx, uly) in cz_tile_origins(index_path).items():
        if not (ulx <= e < ulx + TILE_M and uly - TILE_M < n <= uly):
            continue
        d = (e - (ulx + TILE_M / 2)) ** 2 + (n - (uly - TILE_M / 2)) ** 2
        if best is None or d < best[0]:
            best = (d, name, (ulx, uly))
    if best is None:
        raise ValueError(
            f"point (lat={lat}, lon={lon}) is outside the CZ Sentinel-2 grid")
    _, name, origin = best
    cell = cell_from_xy(origin, e, n)
    return {"tile": name, "cell": cell,
            "bounds": tile_cell_bounds(origin, cell),
            "crs": 32600 + UTM_ZONE, "utm": (e, n)}


def parse_selection(text: str) -> Tuple[str, int]:
    """'T33UVR:42' (the string the map writes) -> ('T33UVR', 42)."""
    tile, _, cell = text.strip().partition(":")
    tile = tile.upper()
    if not tile.startswith("T"):
        tile = "T" + tile
    if tile not in CZ_TILES:
        raise ValueError(f"unknown CZ tile {tile!r}")
    idx = int(cell)
    if not 0 <= idx < 100:
        raise ValueError(f"cell index {idx} outside 0..99")
    return tile, idx


_JS = """
var svg=document.getElementById('czmap');
var vb=svg.viewBox.baseVal, drag=null, sel=document.querySelector('rect.sel');
function setStatus(t){document.getElementById('status').textContent=t;}
svg.addEventListener('pointerdown',function(e){
  drag={x:e.clientX,y:e.clientY,vx:vb.x,vy:vb.y};svg.setPointerCapture(e.pointerId);});
svg.addEventListener('pointermove',function(e){
  if(!drag)return;var s=vb.width/svg.clientWidth;
  vb.x=drag.vx-(e.clientX-drag.x)*s; vb.y=drag.vy-(e.clientY-drag.y)*s;});
svg.addEventListener('pointerup',function(e){
  var moved=drag&&(Math.abs(e.clientX-drag.x)+Math.abs(e.clientY-drag.y)>4);
  drag=null;
  if(moved)return;
  var t=e.target;
  if(t.tagName==='rect'&&t.dataset.tile){
    if(sel)sel.classList.remove('sel');
    t.classList.add('sel');sel=t;
    var id=t.dataset.tile+':'+t.dataset.cell;
    setStatus('selected '+id);
    try{location.hash=id;}catch(err){}
  }});
svg.addEventListener('wheel',function(e){
  e.preventDefault();
  var k=e.deltaY>0?1.2:1/1.2;
  var px=vb.x+vb.width*e.offsetX/svg.clientWidth;
  var py=vb.y+vb.height*e.offsetY/svg.clientHeight;
  vb.x=px-(px-vb.x)*k; vb.y=py-(py-vb.y)*k;
  vb.width*=k; vb.height*=k;},{passive:false});
"""


def cz_grid_map_html(selected: Optional[str] = None,
                     index_path: Optional[str] = None,
                     path: Optional[str] = None) -> str:
    """Self-contained interactive CZ grid map (SVG + vanilla JS).

    ``selected``: optional 'T33UVR:42' to pre-highlight. ``path``: also
    write the HTML there (open it in any browser). Returns the HTML string.
    """
    origins = cz_tile_origins(index_path)
    sel_tile, sel_cell = (parse_selection(selected) if selected
                          else (None, None))
    # world metres -> svg units (1 unit = 100 m), y flipped
    min_e = min(o[0] for o in origins.values())
    max_n = max(o[1] for o in origins.values())
    max_e = max(o[0] for o in origins.values()) + TILE_M
    min_n = min(o[1] for o in origins.values()) - TILE_M
    s = 1.0 / 100.0
    w, h = (max_e - min_e) * s, (max_n - min_n) * s
    cell_u = TILE_M / 10 * s

    rects, labels = [], []
    for name, (ulx, uly) in origins.items():
        x0, y0 = (ulx - min_e) * s, (max_n - uly) * s
        for idx in range(100):
            r, c = divmod(idx, 10)
            cls = ' class="sel"' if (name == sel_tile and
                                     idx == sel_cell) else ""
            rects.append(
                f'<rect x="{x0 + c * cell_u:.1f}" y="{y0 + r * cell_u:.1f}"'
                f' width="{cell_u:.1f}" height="{cell_u:.1f}"'
                f' data-tile="{name}" data-cell="{idx}"{cls}>'
                f'<title>{name} #{idx}</title></rect>')
        labels.append(f'<text x="{x0 + TILE_M / 2 * s:.1f}"'
                      f' y="{y0 + TILE_M / 2 * s:.1f}">'
                      f'{_html.escape(name)}</text>')
    status = (f"selected {sel_tile}:{sel_cell}" if sel_tile
              else "click a cell (drag to pan, wheel to zoom)")
    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><style>
 body{{margin:0;font:13px sans-serif;background:#fdfcf9}}
 #status{{padding:4px 8px;color:#264653}}
 svg{{width:100%;height:480px;cursor:grab;touch-action:none}}
 rect{{fill:#e9c46a;fill-opacity:.25;stroke:#264653;stroke-width:.6;
      vector-effect:non-scaling-stroke}}
 rect:hover{{fill-opacity:.55}}
 rect.sel{{fill:#2a9d8f;fill-opacity:.75}}
 text{{font-size:28px;fill:#26465399;text-anchor:middle;
      pointer-events:none}}
</style></head><body>
<div id="status">{status}</div>
<svg id="czmap" viewBox="0 0 {w:.1f} {h:.1f}"
     xmlns="http://www.w3.org/2000/svg">
<g>{''.join(rects)}</g>{''.join(labels)}
</svg>
<script>{_JS}</script>
</body></html>"""
    if path is not None:
        with open(path, "w") as f:
            f.write(doc)
    return doc
