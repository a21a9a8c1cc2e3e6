"""crop2seg_tpu_torch's serving from disk (webapp/pipeline.py), its UI
copies (webapp/map_picker.py, webapp/app.py, utils/visualize.py) and
utils/profiling.py, on the CPU, held against the JAX package.

The model is TimeUNet at small width (encoder_widths (8, 8, 16), d_model
32, T = 5, as tests/test_webapp.py), the JAX weights carried across by
utils/convert.py. Tolerances:
- ``stream_tile_inference`` / ``generate_prediction`` against the JAX
  functions: proba within 4e-3 absolute (JAX fetches its probabilities in
  bf16: half an ulp of a value <= 1 is 2**-9 ~ 1.95e-3, and a
  renormalization follows); classes identical wherever the port's top-2
  margin is >= 1e-4, and equal on >= 99.9 % of all pixels; the port's own
  proba sums to 1 within 1e-5.
- the copied numpy functions: the same code as their JAX twins
  (``same_code``), and the JAX tests of them run on the port.

The JAX stream recycles its two decode buffers as soon as ``jnp.asarray``
returns; on the CPU backend that array can share the buffer's memory, so
with more than two chunks a later decode can overwrite a chunk the forward
has not read yet. It is held here at no more than two chunks (batch 50 for
100 patches), where no buffer is reused.
"""
import json
import os

import numpy as np
import pytest
import torch

from tests.torch_port_mirror import jax_native, mirror_jax_tests, same_code

CONF = {"model": "timeunet", "num_classes": 15, "input_dim": 10,
        "encoder_widths": [8, 8, 16], "decoder_widths": [4, 8, 16],
        "out_conv": [8, 15], "n_head": 4, "d_model": 32, "d_k": 4,
        "ref_date": "2018-09-01"}
T = 5
AFFINE = [10.0, 0.0, 500000.0, 0.0, -10.0, 5600000.0]
NORM = {"mean": [500.0] * 10, "std": [100.0] * 10}
PROBA_TOL, MARGIN, AGREE = 4e-3, 1e-4, 0.999
FIELD = 16


def write_cell(folder: str, n: int, hw: int, seed: int = 0) -> None:
    """A for-inference cell of ``n`` float32 patches (T, 10, hw, hw) in the
    DatasetCreator layout. The values are fields: 16^2 blocks of one
    spectral profile each, plus noise, so that the class map has parcels."""
    os.makedirs(os.path.join(folder, "DATA_S2"))
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        f = min(FIELD, hw)
        fields = rng.normal(500, 100, (T, 10, hw // f, hw // f))
        x = np.repeat(np.repeat(fields, f, 2), f, 3) + rng.normal(0, 1, (T, 10, hw, hw))
        np.save(os.path.join(folder, "DATA_S2", f"S2_{i}.npy"), x.astype(np.float32))
        records.append({"ID_PATCH": i, "TILE": "T33UVR", "Status": "OK",
                        "time-series_length": T, "crs": 32633, "set": "", "Fold": 1,
                        "dates-S2": {str(j): 20190100 + j + 1 for j in range(T)},
                        "affine": AFFINE})
    with open(os.path.join(folder, "metadata.json"), "w") as f:
        json.dump(records, f)


def write_model_dirs(root: str, variables) -> tuple:
    """conf.json + NORM_S2_patch.json + the weights, twice: the JAX
    package's orbax checkpoint, and the port's torch.save one."""
    from crop2seg_tpu.learning import checkpoint as jax_ckpt
    from crop2seg_tpu_torch.learning import checkpoint as ckpt
    from crop2seg_tpu_torch.models.factory import get_model
    from crop2seg_tpu_torch.utils.convert import timeunet_state_dict_from_flax

    dirs = []
    for side in ("jax", "port"):
        d = os.path.join(root, f"model_{side}")
        os.makedirs(os.path.join(d, "Fold_1"))
        with open(os.path.join(d, "conf.json"), "w") as f:
            json.dump({**CONF, "dtype": "bfloat16"}, f)
        with open(os.path.join(d, "NORM_S2_patch.json"), "w") as f:
            json.dump({"Fold_1": NORM}, f)
        dirs.append(d)
    jax_ckpt.save_converted(os.path.join(dirs[0], "Fold_1"), variables)
    model = get_model(CONF, device="cpu")
    model.load_state_dict(timeunet_state_dict_from_flax(variables))
    ckpt.save_state(os.path.join(dirs[1], "Fold_1"), model, None, 0, 0.0)
    return dirs[0], dirs[1], model


def jax_variables(hw: int):
    import jax
    import jax.numpy as jnp

    from crop2seg_tpu.models.factory import get_model as jax_get_model

    model = jax_get_model({**CONF, "use_pallas": False})
    init = jax.jit(lambda key, x, d: model.init(key, x, d, train=False))
    v = init(jax.random.PRNGKey(0), jnp.zeros((1, T, hw, hw, 10)), jnp.zeros((1, T)))
    return model, jax.tree_util.tree_map(np.asarray, v)


def assert_agree(proba, classes, want_proba, want_classes):
    """The module docstring's tolerances."""
    assert proba.shape == want_proba.shape and classes.shape == want_classes.shape
    assert proba.dtype == np.float32 and classes.dtype == np.uint8
    assert np.isfinite(proba).all()
    np.testing.assert_allclose(proba.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(classes, proba.argmax(-1))
    np.testing.assert_allclose(proba, want_proba, rtol=0, atol=PROBA_TOL)
    top2 = np.sort(proba, -1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] >= MARGIN
    np.testing.assert_array_equal(classes[sure], want_classes[sure])
    assert (classes == want_classes).mean() >= AGREE


@pytest.fixture(scope="module")
def jn(tmp_path_factory):
    return jax_native(tmp_path_factory.mktemp("jax_native"))


def make_cell100(root: str, hw: int) -> dict:
    """A 100-patch cell of hw^2 patches with both model directories."""
    write_cell(os.path.join(root, "cell"), 100, hw)
    _, v = jax_variables(hw)
    jax_dir, port_dir, _ = write_model_dirs(root, v)
    return {"root": root, "cell": os.path.join(root, "cell"), "jax_dir": jax_dir,
            "port_dir": port_dir, "hw": hw}


@pytest.fixture(scope="module")
def cell16(tmp_path_factory, jn):
    """test_webapp.py's partial cell: 16 patches of 32^2 (a 4x4 grid)."""
    root = str(tmp_path_factory.mktemp("cell16"))
    write_cell(os.path.join(root, "cell"), 16, 32)
    jax_model, v = jax_variables(32)
    jax_dir, port_dir, model = write_model_dirs(root, v)
    return {"root": root, "cell": os.path.join(root, "cell"), "jax_dir": jax_dir,
            "port_dir": port_dir, "jax_model": jax_model, "variables": v, "model": model}


def _datasets(folder):
    from crop2seg_tpu.data import S2TSCZCropDataset as JaxDataset
    from crop2seg_tpu_torch.data import S2TSCZCropDataset

    kw = dict(norm=True, norm_values={k: np.asarray(v, np.float32) for k, v in NORM.items()},
              set_type="train", for_inference=True, reference_date="2018-09-01")
    return S2TSCZCropDataset(folder, **kw), JaxDataset(folder, **kw)


def test_stream_tile_inference_partial_cell_matches_jax(cell16):
    """16 patches of 32^2 stream through batch-10 chunks (the last padded)
    and stitch to a 128^2 map (the 1098 crop keeps the whole grid), as
    test_webapp.py's partial cell; against the JAX stream; the timeline's
    keys and contract."""
    from crop2seg_tpu.webapp.pipeline import stream_tile_inference as jax_stream
    from crop2seg_tpu_torch.webapp.pipeline import stream_tile_inference

    ds, jds = _datasets(cell16["cell"])
    assert ds.native_batch_plan() is not None
    tl = {}
    proba, classes = stream_tile_inference(cell16["model"], ds, batch_size=10,
                                           timeline=tl, device="cpu")
    assert proba.shape == (128, 128, 15) and classes.shape == (128, 128)
    want_p, want_c = jax_stream(cell16["jax_model"], cell16["variables"], jds, batch_size=10)
    assert_agree(proba, classes, want_p, want_c)
    assert set(tl) == {"decode", "upload", "dispatch", "fetch", "bytes_up", "total",
                       "decode_busy"}
    stages = tl["decode"] + tl["upload"] + tl["dispatch"] + tl["fetch"]
    assert 0 < stages <= tl["total"] + 1e-6
    assert tl["bytes_up"] == 2 * 10 * T * 10 * 32 * 32 * 2     # two bf16 chunks
    assert tl["decode_busy"] > 0


def test_stream_without_native_plan(cell16):
    """The stream decodes with the native loader only: a dataset that gives
    it no plan (here the RAM cache, or NDVI) raises and names the option."""
    from crop2seg_tpu_torch.data import S2TSCZCropDataset
    from crop2seg_tpu_torch.webapp.pipeline import stream_tile_inference

    for option, kw in (("cache", {"cache": True}), ("add_ndvi", {"add_ndvi": True})):
        plain = S2TSCZCropDataset(cell16["cell"], norm=True, norm_values=NORM,
                                  set_type="train", for_inference=True,
                                  reference_date="2018-09-01", **kw)
        assert plain.native_batch_plan() is None
        with pytest.raises(ValueError, match=f"native loader.*without {option}"):
            stream_tile_inference(cell16["model"], plain, batch_size=16, device="cpu")


def test_stream_stitch_matches_numpy_twin(cell16):
    """The stream's on-device stitch equals the host stitch of the JAX
    package's np_stitch_inference_tile over the per-chunk softmax."""
    from crop2seg_tpu.ops.patchify import np_stitch_inference_tile
    from crop2seg_tpu_torch import native
    from crop2seg_tpu_torch.webapp.pipeline import stream_tile_inference

    ds, _ = _datasets(cell16["cell"])
    proba, _ = stream_tile_inference(cell16["model"], ds, batch_size=16, device="cpu")
    plan = ds.native_batch_plan()
    paths = [ds.light_item(i)["path"] for i in range(16)]
    x, _, _ = native.load_batch(paths, T, 32, 32, reorder=plan["reorder"], mean=plan["mean"],
                                std=plan["std"], layout="nchw", out_dtype="bf16")
    meta = ds.light_item(0)
    with torch.inference_mode():
        logits = cell16["model"](x.permute(0, 1, 3, 4, 2).float(),
                                 torch.tensor(meta["dates"])[None].expand(16, T),
                                 torch.zeros(16, T, dtype=torch.bool))
    want = np_stitch_inference_tile(torch.softmax(logits, -1).numpy())
    np.testing.assert_array_equal(proba, want)


def check_generate_prediction(cell):
    """The 100-patch cell end to end on the CPU (test_webapp.py's case):
    port (batch 10, ten chunks) against the JAX generate_prediction (batch
    50); the cache files; homogenized 0 outside the parcels; the GIS outputs
    are the JAX functions' on the port's classes, exactly."""
    from crop2seg_tpu.gis.postprocess import homogenize_raster, polygonize, soften_by_segments
    from crop2seg_tpu.gis.raster import Affine
    from crop2seg_tpu.gis.vectorize import segments_to_polygons
    from crop2seg_tpu.webapp.pipeline import generate_prediction as jax_generate
    from crop2seg_tpu_torch.webapp.pipeline import generate_prediction

    hw = min(10 * cell["hw"], 1098)
    parcels = np.zeros((hw, hw), np.int64)
    parcels[:hw // 2, :hw // 2] = 1
    parcels[hw * 3 // 5:hw * 4 // 5, hw // 10:hw * 2 // 5] = 2
    cache = os.path.join(cell["root"], "cache_port")
    tl = {}
    got = generate_prediction(cell["cell"], cell["port_dir"], 2019, cache,
                              lpis_parcels=parcels, batch_size=10, device="cpu",
                              timeline=tl)
    want = jax_generate(cell["cell"], cell["jax_dir"], 2019,
                        os.path.join(cell["root"], "cache_jax"), use_pallas=False,
                        lpis_parcels=parcels, batch_size=50)
    assert set(got) == set(want) == {"proba", "classes", "segments", "soft", "polygons",
                                     "lpis", "homogenized"}
    assert got["proba"].shape == (hw, hw, 15)
    assert_agree(got["proba"], got["classes"], want["proba"], want["classes"])
    assert tl["bytes_up"] == 10 * 10 * T * 10 * cell["hw"] ** 2 * 2

    segments, seg_class = polygonize(got["classes"])
    np.testing.assert_array_equal(got["segments"], segments)
    np.testing.assert_array_equal(got["soft"], soften_by_segments(got["proba"], segments)["raster"])
    assert got["polygons"] == segments_to_polygons(segments, seg_class, Affine(*AFFINE))
    np.testing.assert_array_equal(got["homogenized"], homogenize_raster(got["classes"], parcels))
    assert (got["homogenized"][parcels == 0] == 0).all()
    pred = os.path.join(cache, "prediction")
    for name in ("classes.npy", "homogenized.npy", "prediction.shp", "prediction.shx",
                 "prediction.dbf", "prediction.geojson"):
        assert os.path.exists(os.path.join(pred, name)), name
    assert os.path.exists(os.path.join(pred, "prediction.tif")) or \
        os.path.exists(os.path.join(pred, "prediction.npz"))
    np.testing.assert_array_equal(np.load(os.path.join(pred, "classes.npy")), got["classes"])
    with open(os.path.join(pred, "prediction.geojson")) as f:
        assert len(json.load(f)["features"]) == len(got["polygons"])


def test_generate_prediction_matches_jax(tmp_path, jn):
    """100 patches of 32^2 (a 320^2 map): the whole path, quickly."""
    check_generate_prediction(make_cell100(str(tmp_path), 32))


@pytest.mark.slow
def test_generate_prediction_full_cell_matches_jax(tmp_path, jn):
    """100 patches of 128^2 (the 1098^2 map). Slow: about 2.5 min on one
    CPU, most of it the post-processing of a random-weights map (~200k
    segments) on each side."""
    check_generate_prediction(make_cell100(str(tmp_path), 128))


def test_generate_prediction_reads_a_reference_checkpoint(cell16, tmp_path):
    """Fold_1/model.pth.tar (the reference's torch checkpoint) serves the
    same map as the port's model.ckpt; a JAX orbax checkpoint (a directory)
    is refused."""
    import shutil

    from crop2seg_tpu_torch.webapp.pipeline import generate_prediction

    ref_dir = str(tmp_path / "model_ref")
    shutil.copytree(cell16["port_dir"], ref_dir)
    os.remove(os.path.join(ref_dir, "Fold_1", "model.ckpt"))
    torch.save({"state_dict": cell16["model"].state_dict(), "epoch": 3},
               os.path.join(ref_dir, "Fold_1", "model.pth.tar"))
    a = generate_prediction(cell16["cell"], cell16["port_dir"], 2019, str(tmp_path / "a"),
                            device="cpu")
    b = generate_prediction(cell16["cell"], ref_dir, 2019, str(tmp_path / "b"), device="cpu")
    np.testing.assert_array_equal(a["proba"], b["proba"])
    with pytest.raises(ValueError, match="orbax"):
        generate_prediction(cell16["cell"], cell16["jax_dir"], 2019, str(tmp_path / "c"),
                            device="cpu")


def test_serving_device_and_mesh_contract(cell16, tmp_path):
    """The card by default (here none: it raises, never falls back to the
    CPU); device="cpu" serves on one device. The port takes no mesh (one
    card serves; multi-card serving is ROADMAP.md M11)."""
    from crop2seg_tpu_torch.webapp.pipeline import generate_prediction, stream_tile_inference

    ds, _ = _datasets(cell16["cell"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate_prediction(cell16["cell"], cell16["port_dir"], 2019, str(tmp_path / "a"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stream_tile_inference(cell16["model"], ds)
    proba, _ = stream_tile_inference(cell16["model"], ds, device="cpu")
    assert proba.shape == (128, 128, 15)
    with pytest.raises(TypeError, match="mesh"):
        stream_tile_inference(cell16["model"], ds, mesh="auto", device="cpu")


def test_generate_prediction_keeps_the_prediction_years_ref_date(cell16, tmp_path, monkeypatch):
    """conf.json's ref_date and dtype are dropped: the dates count from
    {year-1}-09-01 of the prediction year, as in JAX."""
    from crop2seg_tpu_torch.webapp import pipeline

    seen = {}
    real = pipeline.stream_tile_inference

    def spy(model, ds, *a, **kw):
        seen["ref"] = ds.reference_date
        seen["dates"] = ds.light_item(0)["dates"]
        return real(model, ds, *a, **kw)

    monkeypatch.setattr(pipeline, "stream_tile_inference", spy)
    pipeline.generate_prediction(cell16["cell"], cell16["port_dir"], 2020, str(tmp_path),
                                 device="cpu")
    assert seen["ref"].isoformat().startswith("2019-09-01")
    np.testing.assert_array_equal(seen["dates"][:2], [-243, -242])


# --- copies: the same code, the JAX tests on the port ----------------------

PIPELINE_COPIES = ["CELL_PX", "CELLS_PER_SIDE", "TILE_PX", "tile_cell_bounds",
                   "cell_from_xy", "cell_grid_figure", "get_info", "tile_origin_from_index",
                   "mgrs_tile_origin", "get_time_series", "CacheManager"]


@pytest.mark.parametrize("rel,names", [("utils/visualize.py", None),
                                       ("webapp/map_picker.py", None),
                                       ("webapp/pipeline.py", PIPELINE_COPIES)])
def test_copy_has_the_jax_code(rel, names):
    assert same_code(rel, names) == {}


def test_app_is_the_jax_app_but_its_labels():
    """webapp/app.py differs from the JAX app only in the two labels that
    name the device."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    jax_src = (root / "crop2seg_tpu/webapp/app.py").read_text()
    port_src = (root / "crop2seg_tpu_torch/webapp/app.py").read_text()
    strip = lambda s: s[s.index('"""', 3) + 3:]                     # noqa: E731
    mapped = strip(jax_src).replace("crop2seg_tpu.", "crop2seg_tpu_torch.")
    mapped = mapped.replace("(TPU)", "(GPU)").replace("Running TPU inference",
                                                      "Running GPU inference")
    mapped = mapped.replace("# streamlit is not baked into this image",
                            "# streamlit is optional")
    assert strip(port_src) == mapped


MIRRORED = []
for _stem, _skip in (("test_visualize", ()),
                     ("test_map_picker", ("test_tile_geometry_constants_agree",)),
                     ("test_app_shell", ()),
                     # the rest of test_webapp.py builds JAX models: their
                     # port versions are the tests above
                     ("test_webapp", ("test_generate_prediction_end_to_end",
                                      "test_prediction_vector_cache",
                                      "test_stream_tile_inference_partial_cell"))):
    MIRRORED += mirror_jax_tests(_stem, globals(), skip=_skip)


def test_mirrored_every_jax_case():
    assert len(MIRRORED) == 9 + 7 + 5 + 6


def test_map_picker__tile_geometry_constants_agree():
    """test_map_picker.py's case on the port: the cell and tile geometry
    of pipeline, patchify, dataset_creator and map_picker agree."""
    from crop2seg_tpu.ops import patchify as jax_patchify
    from crop2seg_tpu_torch.gis import dataset_creator
    from crop2seg_tpu_torch.ops import patchify
    from crop2seg_tpu_torch.webapp import map_picker, pipeline

    assert pipeline.CELL_PX == patchify.INFER_TILE == dataset_creator.INFER_TILE
    assert pipeline.CELLS_PER_SIDE == dataset_creator.INFER_GRID
    assert pipeline.TILE_PX == jax_patchify.TRAIN_TILE
    assert pipeline.TILE_PX == pipeline.CELL_PX * pipeline.CELLS_PER_SIDE
    assert map_picker.TILE_M == pipeline.TILE_PX * 10.0


# --- utils/profiling.py ------------------------------------------------------

def test_profiling_counts_and_timers(tmp_path):
    """count_params equals the JAX count of the same weights;
    model_characteristics counts FLOPs and bytes of one forward;
    inference_time, trace and StepMeter on the CPU."""
    from crop2seg_tpu.utils.profiling import count_params as jax_count_params
    from crop2seg_tpu_torch.models.factory import get_model
    from crop2seg_tpu_torch.utils import profiling
    from crop2seg_tpu_torch.utils.convert import timeunet_state_dict_from_flax

    _, v = jax_variables(32)
    model = get_model(CONF, device="cpu")
    model.load_state_dict(timeunet_state_dict_from_flax(v))
    assert profiling.count_params(model) == jax_count_params(v)
    ch = profiling.model_characteristics(model, batch_shape=(1, T, 32, 32, 10), device="cpu")
    assert ch["n_params"] == jax_count_params(v)
    # at least the 3x3 in_conv's multiply-adds over every frame
    assert ch["flops"] >= 2 * T * 32 * 32 * 10 * 8 * 9
    assert ch["bytes_accessed"] >= T * 32 * 32 * 10 * 4
    x = torch.zeros(1, T, 32, 32, 10)
    d = torch.zeros(1, T)
    m = torch.zeros(1, T, dtype=torch.bool)
    with torch.inference_mode():
        stats = profiling.inference_time(model, (x, d, m), repetitions=3, warmup=1)
        with profiling.trace(str(tmp_path / "trace")) as prof:
            model(x, d, m)
    assert set(stats) == {"mean_ms", "std_ms", "p50_ms", "p99_ms"} and stats["mean_ms"] > 0
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any("conv" in e.key for e in prof.key_averages())
    meter = profiling.StepMeter()
    meter.update(4)
    meter.update(4)
    r = meter.rates()
    assert meter.steps == 2 and r["samples_per_sec"] == pytest.approx(4 * r["steps_per_sec"])
