"""Sentinel-2 acquisition CLI of crop2seg_tpu_torch (the counterpart of the
JAX package's sentinel_cli.py, with its flags), on
crop2seg_tpu_torch.gis.sentinel.CopernicusClient: query + download + unzip
for a tile or polygon, or a whole per-month time series; ``--overpass``
predicts the coming Sentinel-2A/B overpasses of an area.

    python -m crop2seg_tpu_torch.sentinel_cli --tile T33UVR --query_only \
        --config config.ini
"""
import argparse
import json
import logging
import sys

parser = argparse.ArgumentParser(prog="python -m crop2seg_tpu_torch.sentinel_cli",
                                 description=__doc__)
parser.add_argument("--config", default=None,
                    help="config.ini / .json with credentials + defaults")
parser.add_argument("--tile", default=None, help="tile name, e.g. T33UVR")
parser.add_argument("--polygon", default=None,
                    help="JSON list of [lon, lat] vertices defining the AOI")
parser.add_argument("--date_start", default=None,
                    help="ISO start datetime, e.g. 2019-04-01T00:00:00.000Z")
parser.add_argument("--date_end", default=None)
parser.add_argument("--count", default=1, type=int,
                    help="number of best-ranked products to download")
parser.add_argument("--max_cloud", default=None, type=int)
parser.add_argument("--producttype", default="S2MSI2A",
                    help="S2MSI2A (L2A) or S2MSI1C (L1C)")
parser.add_argument("--path_dataset", default=None,
                    help="output directory (default: config path_dataset)")
parser.add_argument("--time_series", action="store_true",
                    help="download the full per-month time series for --tile "
                         "using the config's date buckets + cloud caps")
parser.add_argument("--unzip", action="store_true")
parser.add_argument("--query_only", action="store_true",
                    help="print the ranked candidates, download nothing")
parser.add_argument("--overpass", action="store_true",
                    help="predict upcoming Sentinel-2A/B overpasses for the "
                         "AOI (reference sentinel2_overpasses, "
                         "sentinel.py:1342-1428) and print/export a CSV")
parser.add_argument("--days_after", default=7, type=int,
                    help="prediction horizon in days for --overpass")
parser.add_argument("--overpass_csv", default=None,
                    help="optional CSV output path for --overpass")
parser.add_argument("--api_key", default=None,
                    help="spectator.earth API key for --overpass")
parser.add_argument("--account", default=None)
parser.add_argument("--password", default=None)


def main(argv=None):
    args = parser.parse_args(argv)
    from crop2seg_tpu_torch.config import load_config
    from crop2seg_tpu_torch.gis.sentinel import CopernicusClient

    cfg = load_config(args.config)
    if args.account:
        cfg.account = args.account
    if args.password:
        cfg.password = args.password

    if args.overpass:
        import requests

        from crop2seg_tpu_torch.gis.safe_legacy import sentinel2_overpasses

        polygon = json.loads(args.polygon) if args.polygon else None
        if polygon:
            lons = [p[0] for p in polygon]
            lats = [p[1] for p in polygon]
            aoi = (min(lons), min(lats), max(lons), max(lats))
        else:
            aoi = (19.59, 49.90, 20.33, 50.21)  # reference default AOI
        rows = sentinel2_overpasses(aoi, days_after=args.days_after,
                                    session=requests.Session(),
                                    api_key=args.api_key,
                                    export_csv=args.overpass_csv)
        for r in rows:
            logging.info("%s  %s  acquisition=%s  (%.3f, %.3f)",
                         r["date"].isoformat(), r["satellite"],
                         r["acquisition"], r["longitude"], r["latitude"])
        return 0

    out_dir = args.path_dataset or cfg.sentinel_path_dataset
    if not out_dir:
        parser.error("--path_dataset (or config path_dataset) is required")
    client = CopernicusClient(cfg)

    if args.time_series:
        if not args.tile:
            parser.error("--time_series requires --tile")
        results = client.fetch_time_series(args.tile, out_dir)
        for bucket, products in results.items():
            logging.info("%s -> %s", bucket, [p.title for p in products])
        if args.unzip:
            client.unzip(out_dir)
        return 0

    kwargs = {"platformname": "Sentinel-2", "producttype": args.producttype}
    if args.tile:
        kwargs["filename"] = f"*{args.tile}*"
    if args.date_start and args.date_end:
        kwargs["beginposition"] = f"[{args.date_start} TO {args.date_end}]"
    polygon = json.loads(args.polygon) if args.polygon else None
    products = client.query(polygon=polygon, count=args.count,
                            max_cloud=args.max_cloud, **kwargs)
    for p in products:
        logging.info("%-60s cloud=%5.1f%% snow=%5.1f%% size=%7.1fMB rank=%.2f",
                     p.title, p.cloud, p.snow, p.size_mb, p.rank)
    if args.query_only:
        return 0
    client.download(products, out_dir)
    if args.unzip:
        client.unzip(out_dir)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    sys.exit(main())
