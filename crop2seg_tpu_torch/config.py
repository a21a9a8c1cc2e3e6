"""Typed configuration system.

Replaces the reference's three-tier config (INI -> module constants at
reference src/global_vars.py:1-73, argparse per run, persisted
conf.json) with one typed dataclass that can be loaded from the same
config.ini format, from JSON, or constructed directly. The reference
defaults (CZ tile list, 14 date buckets, per-month cloud caps) are built in.
"""
from __future__ import annotations

import configparser
import dataclasses
import json
import os
from typing import List, Optional, Tuple

# 12 CZ Sentinel-2 tiles (reference config.ini [tiles])
DEFAULT_TILES = (
    "T33UVS", "T33UWS",
    "T33UUR", "T33UVR", "T33UWR", "T33UXR", "T33UYR",
    "T33UUQ", "T33UVQ", "T33UWQ", "T33UXQ", "T33UYQ",
)

# 14 month buckets Sep 2018 .. Oct 2019 (reference config.ini [dates])
DEFAULT_DATE_RANGES = tuple(
    f"[{y}-{m:02d}-01T00:00:00.000Z TO {y}-{m:02d}-{d}T00:00:00.000Z]"
    for y, m, d in (
        (2018, 9, 30), (2018, 10, 31), (2018, 11, 30), (2018, 12, 31),
        (2019, 1, 31), (2019, 2, 28), (2019, 3, 31), (2019, 4, 30),
        (2019, 5, 31), (2019, 6, 30), (2019, 7, 31), (2019, 8, 31),
        (2019, 9, 30), (2019, 10, 31),
    ))

# per-bucket max cloud cover % (reference config.ini [clouds])
DEFAULT_CLOUDS = (65, 65, 65, 65, 65, 35, 65, 20, 55, 15, 25, 55, 45, 35)


@dataclasses.dataclass
class SentinelConfig:
    """Acquisition / data-engineering settings (global_vars.py:17-73)."""

    odata_uri: str = "https://dhr1.cesnet.cz/odata/v1/"
    odata_resource: str = "Products"
    opensearch_uri: str = "https://dhr1.cesnet.cz/"
    account: str = ""
    password: str = ""
    sentinel_path_dataset: str = ""
    agri_path_dataset: str = ""     # LPIS shapefile path
    tiles: Tuple[str, ...] = DEFAULT_TILES
    dates: Tuple[str, ...] = DEFAULT_DATE_RANGES
    clouds: Tuple[int, ...] = DEFAULT_CLOUDS
    max_cloud: int = 65
    max_snow: int = 40
    min_size_l2a: int = 420
    min_size_l1c: int = 220
    sen2cor: str = ""
    random_state: int = 42
    eps: float = 1e-10

    def with_clouds(self, relax: int) -> "SentinelConfig":
        """Copy with every monthly cloud cap raised by ``relax`` (capped at
        100) — the webapp's retry-with-relaxed-clouds policy (reference
        get_data.py:230-246)."""
        return dataclasses.replace(
            self, clouds=tuple(min(c + relax, 100) for c in self.clouds))

    @classmethod
    def from_ini(cls, path: str) -> "SentinelConfig":
        """Parse the reference config.ini format."""
        conf = configparser.ConfigParser()
        conf.read(path)

        def clean_list(raw: str, cast=str):
            return tuple(cast(i.strip().replace("\n", "").replace(" ", ""))
                         for i in raw.split(",") if i.strip())

        dates = tuple(
            i.replace(" ", "").replace("\n", "").replace("TO", " TO ")
            for i in conf["dates"]["dates"].split(","))
        return cls(
            odata_uri=conf["sentinel"]["odata_uri"],
            odata_resource=conf["sentinel"]["odata_resource"],
            opensearch_uri=conf["sentinel"]["opensearch_uri"],
            account=conf["sentinel"]["account"],
            password=conf["sentinel"]["password"],
            sentinel_path_dataset=conf["sentinel"]["path_dataset"],
            agri_path_dataset=conf["agri"]["path_dataset"],
            tiles=clean_list(conf["tiles"]["tiles"]),
            dates=dates,
            clouds=clean_list(conf["clouds"]["clouds"], int),
            max_cloud=int(conf["clouds"]["max_cloud"]),
            max_snow=int(conf["snow"]["max_snow"]),
            min_size_l2a=int(conf["size"]["min_size_l2a"]),
            min_size_l1c=int(conf["size"]["min_size_l1c"]),
            sen2cor=conf["sen2cor"]["sen2cor"],
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=4)

    @classmethod
    def from_json(cls, path: str) -> "SentinelConfig":
        with open(path) as f:
            blob = json.load(f)
        field_names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in blob.items() if k in field_names}
        return cls(**kwargs)


def load_config(path: Optional[str] = None) -> SentinelConfig:
    """Load config.ini / .json if present, else defaults."""
    if path is None:
        for cand in ("config/config.ini", "config.ini"):
            if os.path.exists(cand):
                path = cand
                break
    if path is None:
        return SentinelConfig()
    if path.endswith(".json"):
        return SentinelConfig.from_json(path)
    return SentinelConfig.from_ini(path)
