"""Copernicus Sentinel-2 acquisition client (OpenSearch query + OData download).

Re-design of reference src/helpers/sentinel.py:44-607 as a class with
an injectable HTTP session (testable without network). Mirrored
behaviors:

- full-text keyword query incl. footprint polygon (reference :44-76)
- candidate ranking  rank = (10 - cloud/(max_cloud//10)) * (size - min_size)/100
  with hard size/cloud/snow filters (reference :109-214)
- OData ``Products('uuid')/$value`` streaming download with skip-if-already-
  downloaded resume (reference :275-330)
- unzip of .SAFE archives (reference :341-377)
- ``fetch_time_series``: the month-bucket orchestration loop with per-bucket
  cloud caps (reference sentinel() :379-607 / webapp get_data.py:208-229)
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urljoin

from crop2seg_tpu_torch.config import SentinelConfig


@dataclasses.dataclass
class Product:
    uuid: str
    title: str
    tile_type: str      # 'L1C' | 'L2A' | 'other'
    cloud: float
    snow: float
    size_mb: float
    rank: float = 0.0
    raw: Optional[dict] = None


def build_keywords(polygon=None, **kwargs) -> str:
    """OpenSearch full-text keywords (reference :44-76)."""
    keywords = [f"{k}:{v}" for k, v in kwargs.items()]
    if polygon is not None:
        pts = ", ".join(f"{p[0]} {p[1]}" for p in polygon)
        pts += f", {polygon[0][0]} {polygon[0][1]}"
        keywords.append(f'footprint:"Intersects(POLYGON(({pts})))"')
    return " AND ".join(keywords)


def rank_product(tile_type: str, cloud: float, size_mb: float,
                 cfg: SentinelConfig) -> float:
    """Cloud/size ranking (reference :109-132); 0 = filtered out."""
    min_size = {"L1C": cfg.min_size_l1c, "L2A": cfg.min_size_l2a}.get(tile_type)
    if min_size is None:
        return 0.0
    if size_mb < min_size or cloud > cfg.max_cloud:
        return 0.0
    return (-(cloud / (cfg.max_cloud // 10)) + 10) * (size_mb / 100 - min_size / 100)


def _parse_entry(entry: dict) -> Product:
    def find(kind, name, default=None):
        items = entry.get(kind, [])
        if isinstance(items, dict):
            items = [items]
        for it in items:
            if it.get("name") == name:
                return it.get("content")
        return default

    level = (find("str", "processinglevel") or "")[-2:]
    tile_type = {"1C": "L1C", "2A": "L2A"}.get(level, "other")
    size_raw = (find("str", "size") or "0 MB").split(" ")
    size_mb = float(size_raw[0]) * (1000.0 if size_raw[1] == "GB" else 1.0)
    return Product(
        uuid=entry["id"], title=entry["title"], tile_type=tile_type,
        cloud=float(find("double", "cloudcoverpercentage", 0.0) or 0.0),
        snow=float(find("double", "snowicepercentage", 0.0) or 0.0),
        size_mb=size_mb, raw=entry)


class CopernicusClient:
    def __init__(self, config: Optional[SentinelConfig] = None, session=None):
        self.cfg = config or SentinelConfig()
        if session is None:
            import requests
            session = requests.Session()
        self.session = session
        self.auth = (self.cfg.account, self.cfg.password)

    # --- query -------------------------------------------------------------
    def query(self, polygon=None, count: int = 5, max_cloud: Optional[int] = None,
              **kwargs) -> List[Product]:
        """Query OpenSearch, filter by snow/cloud/size, rank, return best
        ``count`` products (reference sentinel_query :79-244)."""
        if count > 100:
            raise ValueError("maximum 100 results can be queried")
        keywords = build_keywords(polygon, **kwargs)
        url = urljoin(self.cfg.opensearch_uri,
                      f"search?q=({keywords})&format=json&rows=100")
        logging.info("querying %s", url)
        resp = self.session.get(url, auth=self.auth)
        if resp.status_code == 401:
            raise PermissionError("unauthorized access to OpenSearch API")
        feed = resp.json()["feed"]
        if "entry" not in feed:
            raise RuntimeError("no results matching the conditions "
                               "(cloud filter may be too restrictive)")
        entries = feed["entry"]
        if isinstance(entries, dict):
            entries = [entries]
        products = [_parse_entry(e) for e in entries]

        cfg = self.cfg
        if kwargs.get("platformname", "") == "Sentinel-2":
            products = [p for p in products if p.snow <= cfg.max_snow]
            cloud_cap = cfg.max_cloud if max_cloud is None else max_cloud
            for p in products:
                p.rank = rank_product(p.tile_type, p.cloud, p.size_mb, cfg)
                if p.cloud > cloud_cap:
                    p.rank = 0.0
            products = [p for p in products if p.rank > 0.0]
            products.sort(key=lambda p: -p.rank)
        return products[:count]

    # --- download ----------------------------------------------------------
    def download(self, products: Sequence[Product], path_dataset: str,
                 chunk_size: int = 1 << 20, progress=None) -> List[str]:
        """OData streaming download with resume-if-exists (reference :247-338)."""
        os.makedirs(path_dataset, exist_ok=True)
        written = []
        for i, product in enumerate(products):
            base = os.path.join(path_dataset, product.title)
            with open(base + ".json", "w") as f:
                json.dump(product.raw or dataclasses.asdict(product), f)
            if os.path.exists(base + ".zip") or os.path.exists(base + ".SAFE"):
                logging.info("%s already downloaded", product.title)
                written.append(base)
                continue
            url = urljoin(self.cfg.odata_uri, self.cfg.odata_resource)
            url = f"{url}('{product.uuid}')/$value"
            logging.info("downloading %s", url)
            with self.session.get(url, auth=self.auth, stream=True) as r:
                r.raise_for_status()
                total = int(r.headers.get("Content-Length", 0))
                done = 0
                with open(base + ".zip", "wb") as f:
                    for chunk in r.iter_content(chunk_size=chunk_size):
                        f.write(chunk)
                        done += len(chunk)
                        if progress is not None and total:
                            progress(min(done / total, 1.0), product.title)
            written.append(base)
        return written

    @staticmethod
    def unzip(path_dataset: str, remove_zip: bool = False) -> List[str]:
        """Extract all .zip archives into .SAFE dirs (reference :341-377)."""
        out = []
        for name in sorted(os.listdir(path_dataset)):
            if not name.endswith(".zip"):
                continue
            target = os.path.join(path_dataset, name[:-4] + ".SAFE")
            if os.path.exists(target):
                out.append(target)
                continue
            with zipfile.ZipFile(os.path.join(path_dataset, name)) as zf:
                zf.extractall(path_dataset)
            if remove_zip:
                os.remove(os.path.join(path_dataset, name))
            out.append(target)
        return out

    # --- orchestration -----------------------------------------------------
    def fetch_time_series(self, tile: str, path_dataset: str,
                          dates: Optional[Sequence[str]] = None,
                          clouds: Optional[Sequence[int]] = None,
                          per_bucket: int = 1, progress=None
                          ) -> Dict[str, List[Product]]:
        """Download the best product(s) per month bucket for one tile
        (reference sentinel() :379-607; per-bucket cloud caps from config)."""
        dates = list(dates if dates is not None else self.cfg.dates)
        clouds = list(clouds if clouds is not None else self.cfg.clouds)
        results: Dict[str, List[Product]] = {}
        for bucket, cloud_cap in zip(dates, clouds):
            try:
                products = self.query(
                    polygon=None, count=per_bucket, max_cloud=cloud_cap,
                    platformname="Sentinel-2", producttype="S2MSI2A",
                    filename=f"*{tile}*", beginposition=bucket)
            except RuntimeError as err:
                logging.warning("bucket %s: %s", bucket, err)
                results[bucket] = []
                continue
            self.download(products, path_dataset, progress=progress)
            results[bucket] = products
        return results
