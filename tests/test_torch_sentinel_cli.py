"""crop2seg_tpu_torch's Sentinel-2 acquisition CLI (``python -m
crop2seg_tpu_torch.sentinel_cli``) against the root sentinel_cli.py of the
JAX package: the same flags and defaults, and the same calls into a
Copernicus client whose HTTP session is faked (as tests/test_sentinel.py
fakes it): query, download and unzip, the per-month time series, the
overpass prediction, and the argument errors."""
import importlib.util
import json
import os
import pathlib
import zipfile

import pytest

from crop2seg_tpu_torch import sentinel_cli as port_cli
from crop2seg_tpu_torch.config import SentinelConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_cli():
    spec = importlib.util.spec_from_file_location("crop2seg_sentinel_cli",
                                                  ROOT / "sentinel_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CLI = _jax_cli()
CLIS = {"port": port_cli, "jax": JAX_CLI}


class FakeResponse:
    def __init__(self, payload=None, content=b""):
        self.payload, self._content, self.status_code = payload, content, 200
        self.headers = {"Content-Length": str(len(content))}

    def json(self):
        return self.payload

    def raise_for_status(self):
        pass

    def iter_content(self, chunk_size):
        for i in range(0, len(self._content), chunk_size):
            yield self._content[i:i + chunk_size]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class FakeSession:
    """Answers every query with ``payload`` and every download with
    ``content``; records the URLs asked for."""

    def __init__(self, payload, content=b""):
        self.payload, self.content, self.urls = payload, content, []

    def get(self, url, auth=None, stream=False, **kw):
        self.urls.append(url)
        if "$value" in url:
            return FakeResponse(content=self.content)
        return FakeResponse(payload=self.payload)


def _entry(uuid, title, cloud, size_mb):
    return {"id": uuid, "title": title,
            "str": [{"name": "processinglevel", "content": "Level-2A"},
                    {"name": "size", "content": f"{size_mb} MB"}],
            "double": [{"name": "cloudcoverpercentage", "content": str(cloud)},
                       {"name": "snowicepercentage", "content": "0"}]}


FEED = {"feed": {"entry": [_entry("a", "S2A_T33UVR_best", 5, 900),
                           _entry("b", "S2A_T33UVR_mid", 30, 700),
                           _entry("c", "S2A_T33UVR_cloudy", 90, 900)],
                 "opensearch:totalResults": "3"}}


def _safe_zip(tmp_path) -> bytes:
    path = tmp_path / "product.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("S2A_T33UVR_best.SAFE/MTD.xml", "<xml/>")
    return path.read_bytes()


@pytest.fixture
def session(monkeypatch, tmp_path):
    """Every requests.Session() the clients make is this fake."""
    import requests

    sess = FakeSession(FEED, _safe_zip(tmp_path))
    monkeypatch.setattr(requests, "Session", lambda: sess)
    return sess


def _options(parser):
    return {tuple(a.option_strings): (a.default, a.type, a.nargs, a.const)
            for a in parser._actions}


def test_same_flags_and_defaults_as_the_jax_cli():
    assert _options(port_cli.parser) == _options(JAX_CLI.parser)


@pytest.mark.parametrize("extra", [[], ["--date_start", "2019-04-01T00:00:00.000Z",
                                        "--date_end", "2019-05-01T00:00:00.000Z",
                                        "--max_cloud", "20", "--count", "2"]])
def test_query_only_asks_what_the_jax_cli_asks(session, tmp_path, extra):
    urls = {}
    for name, mod in CLIS.items():
        session.urls.clear()
        argv = ["--tile", "T33UVR", "--query_only", "--path_dataset",
                str(tmp_path / name)] + extra
        assert mod.main(argv) == 0
        urls[name] = list(session.urls)
    assert urls["port"] == urls["jax"] and len(urls["port"]) == 1
    assert "T33UVR" in urls["port"][0]
    assert not os.path.exists(tmp_path / "port")          # nothing downloaded


def test_download_and_unzip_as_the_jax_cli(session, tmp_path):
    trees = {}
    for name, mod in CLIS.items():
        session.urls.clear()
        out = tmp_path / name
        assert mod.main(["--tile", "T33UVR", "--count", "1", "--unzip",
                         "--path_dataset", str(out)]) == 0
        trees[name] = (sorted(os.listdir(out)), list(session.urls))
    assert trees["port"] == trees["jax"]
    assert "S2A_T33UVR_best.SAFE" in trees["port"][0]
    assert any("$value" in u for u in trees["port"][1])


def test_time_series_as_the_jax_cli(session, tmp_path):
    cfg = tmp_path / "config.json"
    SentinelConfig(dates=("[2019-04-01T00:00:00.000Z TO 2019-05-01T00:00:00.000Z]",
                          "[2019-05-01T00:00:00.000Z TO 2019-06-01T00:00:00.000Z]"),
                   clouds=(65, 10)).to_json(str(cfg))
    urls = {}
    for name, mod in CLIS.items():
        session.urls.clear()
        assert mod.main(["--config", str(cfg), "--time_series", "--tile", "T33UVR",
                         "--path_dataset", str(tmp_path / name)]) == 0
        urls[name] = list(session.urls)
    assert urls["port"] == urls["jax"]
    assert sum("T33UVR" in u for u in urls["port"]) >= 2   # one query per bucket


def test_overpass_calls_the_prediction_with_the_polygons_box(session, monkeypatch, tmp_path):
    from crop2seg_tpu_torch.gis import safe_legacy

    calls = []

    def fake(aoi, days_after, session, api_key, export_csv):
        calls.append((aoi, days_after, api_key, export_csv))
        return []
    monkeypatch.setattr(safe_legacy, "sentinel2_overpasses", fake)
    poly = json.dumps([[14.0, 50.0], [15.5, 50.0], [15.5, 51.0]])
    assert port_cli.main(["--overpass", "--polygon", poly, "--days_after", "3",
                          "--api_key", "k", "--overpass_csv", str(tmp_path / "o.csv")]) == 0
    assert port_cli.main(["--overpass"]) == 0
    assert calls == [((14.0, 50.0, 15.5, 51.0), 3, "k", str(tmp_path / "o.csv")),
                     ((19.59, 49.90, 20.33, 50.21), 7, None, None)]


@pytest.mark.parametrize("argv", [["--time_series", "--path_dataset", "x"],
                                  ["--tile", "T33UVR"]])
def test_argument_errors_exit_as_the_jax_cli(session, argv):
    codes = {}
    for name, mod in CLIS.items():
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        codes[name] = e.value.code
    assert codes["port"] == codes["jax"] == 2


def test_account_and_password_reach_the_client(session, monkeypatch, tmp_path):
    from crop2seg_tpu_torch.gis import sentinel

    seen = []
    init = sentinel.CopernicusClient.__init__

    def spy(self, config=None, session=None):
        seen.append((config.account, config.password))
        init(self, config, session)
    monkeypatch.setattr(sentinel.CopernicusClient, "__init__", spy)
    port_cli.main(["--tile", "T33UVR", "--query_only", "--account", "me",
                   "--password", "pw", "--path_dataset", str(tmp_path)])
    assert seen == [("me", "pw")]
