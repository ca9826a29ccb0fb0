"""Compare the field data of two XDMF time series.

A copy of marlin_tpu/xdmfdiff.py, the analog of the reference's
``scripts/xdmfdiff.py`` (a serial-vs-parallel output comparator used by the
TestHarness and by users checking rank-count invariance).  Reads both the
layouts the two packages write (``xdmf.py``: temporal collection,
HDF or inline-XML DataItems, per-rank spatial collections) and the
reference's single-grid layout, pairs snapshots by time value, and reports
per-field max-abs / max-rel differences.

Usage::

    python -m marlin_tpu_torch.xdmfdiff a.xmf b.xmf [--rtol 5.5e-6] [--atol 1e-11]

Exit code 0 when every overlapping field of every paired snapshot is within
tolerance, 1 otherwise (the CSVDiff-style default tolerances match
``tests/gold.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _read_dataitem(item: ET.Element, base_dir: str) -> np.ndarray:
    fmt = (item.get("Format") or "XML").upper()
    text = "".join(item.itertext()).strip()
    dims = item.get("Dimensions")
    if fmt in ("HDF", "HDF5"):
        import h5py

        fname, _, dset = text.partition(":")
        with h5py.File(os.path.join(base_dir, fname), "r") as f:
            return np.asarray(f[dset])
    if fmt == "BINARY":
        # raw .bin sidecar files (this package's default enable_hdf5=false
        # layout): dtype from DataType + Precision
        prec = int(item.get("Precision") or 8)
        kind = (item.get("DataType") or "Float").lower()
        dtype = {("float", 4): np.float32, ("float", 8): np.float64,
                 ("int", 4): np.int32, ("int", 8): np.int64}[(kind, prec)]
        arr = np.fromfile(os.path.join(base_dir, text), dtype=dtype)
        if dims:
            arr = arr.reshape([int(d) for d in dims.split()])
        return arr
    arr = np.array(text.split(), dtype=float)
    if dims:
        arr = arr.reshape([int(d) for d in dims.split()])
    return arr


def _iter_uniform_grids(grid: ET.Element):
    """Yield Uniform grids, flattening nested Spatial collections (the
    parallel per-rank layout)."""
    gtype = grid.get("GridType", "Uniform")
    if gtype == "Uniform":
        yield grid
        return
    for sub in grid:
        if _local(sub.tag) == "Grid":
            yield from _iter_uniform_grids(sub)


def read_series(path: str):
    """-> list of (time, {field_name: array}) snapshots."""
    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    snapshots = []

    def grid_origin_dx(uni):
        """(origin, dx) arrays from an ORIGIN_DXDY(Z) Geometry, or None."""
        for el in uni:
            if _local(el.tag) != "Geometry":
                continue
            items = [c for c in el if _local(c.tag) == "DataItem"]
            if len(items) == 2:
                return (_read_dataitem(items[0], base_dir),
                        _read_dataitem(items[1], base_dir))
        return None

    def visit(grid):
        time = None
        for el in grid:
            if _local(el.tag) == "Time":
                time = float(el.get("Value"))
        # collect per-piece (offset, array); single grids have offset None
        pieces = {}
        for uni in _iter_uniform_grids(grid):
            geo = grid_origin_dx(uni)
            offsets = None
            if geo is not None:
                origin, dx = geo
                with np.errstate(divide="ignore", invalid="ignore"):
                    offsets = tuple(
                        int(round(o / d)) if d else 0
                        for o, d in zip(origin, dx))
            for el in uni:
                if _local(el.tag) != "Attribute":
                    continue
                name = el.get("Name")
                items = [c for c in el if _local(c.tag) == "DataItem"]
                if not items:
                    continue
                arr = _read_dataitem(items[0], base_dir)
                pieces.setdefault(name, []).append((offsets, arr))
        fields = {}
        for name, plist in pieces.items():
            if len(plist) == 1:
                fields[name] = plist[0][1]
                continue
            # spatial collection (one piece per rank): reassemble the
            # global array by placing each piece at its geometry origin
            # (origins and data dims are written in the same axis order)
            if any(off is None or len(off) != p.ndim for off, p in plist):
                fields[name] = np.concatenate(
                    [p.ravel() for _, p in plist])
                continue
            ndim = plist[0][1].ndim
            base = tuple(min(off[d] for off, _ in plist)
                         for d in range(ndim))
            plist = [(tuple(o - b for o, b in zip(off, base)), p)
                     for off, p in plist]
            shape = tuple(
                max(off[d] + p.shape[d] for off, p in plist)
                for d in range(ndim))
            full = np.full(shape, np.nan)
            for off, p in plist:
                full[tuple(slice(o, o + s)
                           for o, s in zip(off, p.shape))] = p
            fields[name] = full
        if fields:
            snapshots.append((time, fields))

    for dom in root:
        if _local(dom.tag) != "Domain":
            continue
        for grid in dom:
            if _local(grid.tag) != "Grid":
                continue
            if grid.get("CollectionType") == "Temporal" or grid.get(
                    "GridType") == "Collection":
                for sub in grid:
                    if _local(sub.tag) == "Grid":
                        visit(sub)
            else:
                visit(grid)
    return snapshots


def _pair_by_time(sa, sb):
    """Nearest-time snapshot pairing with a spacing-aware tolerance.

    np.isclose's fixed atol=1e-8/rtol=1e-5 alone would greedily mis-pair
    frames spaced closer than that (sub-1e-8 dt, tightly-spaced adaptive-dt
    frames), so a candidate must ALSO be nearer than half the LOCAL frame
    gap — the spacing to each time's nearest same-series neighbor — so one
    tightly-spaced adaptive-dt pair somewhere does not clamp matching for
    the whole series.  Returns (pairs, (unpaired_a_times,
    unpaired_b_times))."""
    tb_list = [t for t, _ in sb]

    def local_gap(times, t):
        # distance from t to its nearest other frame in the same series;
        # duplicate-time frames count with their POSITIVE distances only,
        # so a duplicated time yields the smallest positive spacing (a
        # conservative window) rather than skipping its twin and widening
        # the window exactly where matching is ambiguous
        ds = [abs(x - t) for x in times]
        pos = [d for d in ds if d > 0]
        if ds.count(0.0) > 1:  # t itself plus at least one duplicate
            return 0.0
        return min(pos) if pos else np.inf

    ta_list = [t for t, _ in sa]
    pairs = []
    used = set()
    unpaired_a = []
    for ta, fa in sa:
        free = [j for j in range(len(tb_list)) if j not in used]
        best = min(free, key=lambda j: abs(tb_list[j] - ta), default=None)
        if best is not None:
            d = abs(tb_list[best] - ta)
            gap = min(local_gap(ta_list, ta), local_gap(tb_list, tb_list[best]))
            ok = np.isclose(ta, tb_list[best]) and (
                d == 0.0 or not np.isfinite(gap) or d <= gap / 2
            )
            if not ok:
                best = None
        if best is None:
            unpaired_a.append(ta)
            continue
        used.add(best)
        pairs.append(((ta, fa), sb[best]))
    unpaired_b = [t for j, (t, _) in enumerate(sb) if j not in used]
    return pairs, (unpaired_a, unpaired_b)


def compare(path_a: str, path_b: str, rtol: float = 5.5e-6,
            atol: float = 1e-11, out=sys.stdout) -> int:
    """Print the per-snapshot per-field differences; return the number of
    out-of-tolerance (or unpaired) comparisons."""
    sa, sb = read_series(path_a), read_series(path_b)
    failures = 0
    if len(sa) != len(sb):
        print(f"snapshot count differs: {len(sa)} vs {len(sb)}", file=out)
        failures += 1
    # pair by time value when both series carry times (one run may have an
    # extra leading frame — index pairing would misalign every comparison);
    # fall back to index pairing otherwise
    if all(t is not None for t, _ in sa) and all(t is not None for t, _ in sb):
        pairs, unpaired = _pair_by_time(sa, sb)
        for ta in unpaired[0]:
            print(f"t={ta}: no matching snapshot in {path_b}", file=out)
            failures += 1
        for tb in unpaired[1]:
            print(f"t={tb}: no matching snapshot in {path_a}", file=out)
            failures += 1
    else:
        pairs = list(zip(sa, sb))
    for i, ((ta, fa), (tb, fb)) in enumerate(pairs):
        label = f"T{i} (t={ta})"
        if ta is not None and tb is not None and not np.isclose(ta, tb):
            print(f"{label}: time differs ({ta} vs {tb})", file=out)
            failures += 1
        for name in sorted(set(fa) | set(fb)):
            if name not in fa or name not in fb:
                print(f"{label} {name}: only in one file", file=out)
                failures += 1
                continue
            a, b = np.asarray(fa[name], float), np.asarray(fb[name], float)
            if a.size != b.size:
                print(f"{label} {name}: shape {a.shape} vs {b.shape}",
                      file=out)
                failures += 1
                continue
            a, b = a.ravel(), b.ravel()
            adiff = np.abs(a - b)
            max_abs = float(np.nanmax(adiff)) if a.size else 0.0
            denom = np.maximum(np.abs(a), np.abs(b))
            with np.errstate(invalid="ignore", divide="ignore"):
                rel = np.where(denom > 0, adiff / denom, 0.0)
            max_rel = float(np.nanmax(rel)) if a.size else 0.0
            # NaN anywhere is a FAIL unless it appears in BOTH files at the
            # same positions — a diff tool must never pass on NaN noise
            nan_ok = bool(np.array_equal(np.isnan(a), np.isnan(b)))
            both = ~(np.isnan(a) | np.isnan(b))
            ok = nan_ok and bool(
                np.all((adiff[both] <= atol) | (rel[both] <= rtol)))
            status = "OK" if ok else "FAIL"
            print(f"{label} {name}: max abs {max_abs:.3e} "
                  f"max rel {max_rel:.3e} [{status}]", file=out)
            if not ok:
                failures += 1
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="marlin_tpu_torch.xdmfdiff",
        description="Compare fields stored in two XDMF time series.")
    p.add_argument("file_a")
    p.add_argument("file_b")
    p.add_argument("--rtol", type=float, default=5.5e-6,
                   help="relative tolerance (CSVDiff default)")
    p.add_argument("--atol", type=float, default=1e-11,
                   help="absolute floor below which differences pass")
    ns = p.parse_args(argv)
    failures = compare(ns.file_a, ns.file_b, ns.rtol, ns.atol)
    if failures:
        print(f"{failures} difference(s) above tolerance")
        return 1
    print("files match")
    return 0


if __name__ == "__main__":
    sys.exit(main())
