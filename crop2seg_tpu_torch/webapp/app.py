"""Streamlit crop-map UI (run: ``streamlit run crop2seg_tpu_torch/webapp/app.py``;
a copy of crop2seg_tpu/webapp/app.py over the port's pipeline, which serves
on the CUDA card).

Thin shell over crop2seg_tpu_torch.webapp.pipeline mirroring the reference app's
three tabs (Home / Crop map / Cache) and session-state machine
(reference crop2seg.py:47-163,263-385). All heavy lifting is in the
headless pipeline so the app works identically from scripts and notebooks.
"""
from __future__ import annotations

import os

try:
    import streamlit as st
except ImportError as err:  # streamlit is optional
    raise SystemExit(
        "streamlit is not installed; use crop2seg_tpu_torch.webapp.pipeline "
        "directly (generate_prediction / get_info / CacheManager)") from err

import numpy as np

from crop2seg_tpu_torch.config import DEFAULT_TILES
from crop2seg_tpu_torch.data.s2tsczcrop import LABELS
from crop2seg_tpu_torch.utils.visualize import plot_crop_map
from crop2seg_tpu_torch.webapp.map_picker import (
    cz_grid_map_html, parse_selection, pick_patch)
from crop2seg_tpu_torch.webapp.pipeline import (
    CacheManager, cell_grid_figure, generate_prediction, get_info,
    get_time_series)

CACHE_DIR = os.environ.get("CROP2SEG_CACHE", os.path.expanduser("~/.crop2seg"))
MODEL_DIR = os.environ.get("CROP2SEG_MODEL", "data/inference/timeunet_v1_base")


def main():
    st.set_page_config(page_title="crop2seg-tpu", layout="wide")
    page = st.sidebar.radio("Menu", ["Home", "Crop map", "Cache"])
    cache = CacheManager(CACHE_DIR)

    if page == "Home":
        st.title("Predict crops (GPU)")
        # Interactive cell picker: the reference renders the CZ Sentinel-2
        # grid on a leafmap map and spatial-joins the click to a cell
        # (home.py:13-77, get_data.py:33-69). Here the same join runs in
        # closed form (map_picker.pick_patch) from typed WGS84 coordinates,
        # the whole CZ grid renders as a self-contained interactive SVG map
        # (pan/zoom/click, no mapping stack), and a clickable 10x10 button
        # matrix + georeferenced view cover the per-tile flow.
        if "cell" not in st.session_state:
            st.session_state["cell"] = 0
        with st.expander("Locate by coordinates (WGS84)"):
            c1, c2, c3 = st.columns([1, 1, 1])
            lat = c1.number_input("Latitude", 47.0, 52.0, 49.78,
                                  format="%.4f")
            lon = c2.number_input("Longitude", 11.0, 19.5, 15.37,
                                  format="%.4f")
            if c3.button("Locate"):
                try:
                    picked = pick_patch(float(lat), float(lon))
                    st.session_state["tile"] = picked["tile"]
                    st.session_state["cell"] = picked["cell"]
                    st.success(f"{picked['tile']} cell {picked['cell']}")
                except ValueError as e:
                    st.error(str(e))
        with st.expander("Czech Republic grid map (interactive)"):
            sel = f"{st.session_state.get('tile', DEFAULT_TILES[0])}:" \
                  f"{st.session_state['cell']}"
            st.components.v1.html(cz_grid_map_html(selected=sel), height=520)
            typed = st.text_input("Apply map selection (tile:cell)", sel)
            if st.button("Use selection"):
                try:
                    t, c = parse_selection(typed)
                    st.session_state["tile"] = t
                    st.session_state["cell"] = c
                except ValueError as e:
                    st.error(str(e))
        tile = st.selectbox(
            "Sentinel-2 tile", DEFAULT_TILES,
            index=(DEFAULT_TILES.index(st.session_state["tile"])
                   if st.session_state.get("tile") in DEFAULT_TILES else 0))
        # Keep the session tile in sync with the selectbox so the CZ map
        # pre-highlight and the "Apply map selection" default above follow
        # a selectbox change on the next rerun (they render before it).
        st.session_state["tile"] = tile
        map_col, grid_col = st.columns([3, 2])
        with grid_col:
            st.caption("Pick a cell (row-major 0-99)")
            for r in range(10):
                cols = st.columns(10)
                for c, col in enumerate(cols):
                    idx = r * 10 + c
                    if col.button(f"{idx}", key=f"cell_{idx}",
                                  type=("primary"
                                        if st.session_state["cell"] == idx
                                        else "secondary")):
                        st.session_state["cell"] = idx
                        st.rerun()
        with map_col:
            st.pyplot(cell_grid_figure(tile, st.session_state["cell"]))
        cell = st.number_input("Cell index (0-99)", 0, 99,
                               int(st.session_state["cell"]))
        year = st.number_input("Year", 2016, 2026, 2019)
        if st.button("Predict crops"):
            info = get_info(tile, int(cell))
            st.write(f"Acquiring time series for {info['tile']} "
                     f"cell {info['cell']} ...")
            data_folder = get_time_series(tile, info["bounds"], CACHE_DIR)
            st.write("Running GPU inference ...")
            result = generate_prediction(data_folder, MODEL_DIR, int(year),
                                         CACHE_DIR)
            st.session_state["result"] = result
            st.success("Crop map generated")

    elif page == "Crop map":
        st.title("Crop map")
        result = st.session_state.get("result")
        if result is None:
            # fall back to the cached artifacts of the last run
            pred_dir = os.path.join(CACHE_DIR, "prediction")
            path = os.path.join(pred_dir, "classes.npy")
            if os.path.exists(path):
                result = {"classes": np.load(path)}
                hom = os.path.join(pred_dir, "homogenized.npy")
                if os.path.exists(hom):
                    result["homogenized"] = np.load(hom)
        if result is None:
            st.info("No prediction cached yet — run one from Home.")
        else:
            # reference view: 15-class legend map + LPIS overlay toggles
            # (webapp/postprocess.py:59-183)
            layers = ["predicted"]
            if "homogenized" in result:
                layers.append("LPIS-homogenized")
            layer = st.radio("Layer", layers, horizontal=True)
            show_lpis = st.checkbox(
                "LPIS parcel boundaries",
                value=False, disabled=result.get("lpis") is None)
            show_conf = st.checkbox(
                "Dim low-confidence pixels",
                value=False, disabled=result.get("proba") is None)
            classes = (result["homogenized"]
                       if layer == "LPIS-homogenized" else result["classes"])
            fig = plot_crop_map(
                classes, LABELS,
                lpis_parcels=result.get("lpis") if show_lpis else None,
                confidence=(result["proba"].max(-1)
                            if show_conf and result.get("proba") is not None
                            else None))
            st.pyplot(fig)

    else:
        st.title("Cache management")
        for sub, size in cache.sizes().items():
            col1, col2 = st.columns([3, 1])
            col1.write(f"{sub}: {size / 1e6:.1f} MB")
            if col2.button(f"Delete {sub}"):
                cache.clear(sub)
                st.rerun()


if __name__ == "__main__":
    main()
