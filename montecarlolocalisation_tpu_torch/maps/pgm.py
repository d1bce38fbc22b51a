"""ROS `map_server` occupancy maps: a PGM image and its YAML metadata.

A copy of montecarlolocalisation_tpu/maps/pgm.py for the port, with the
same map_server semantics:

  * occupancy p = (255 - v) / 255 per pixel (v / 255 with `negate: 1`);
  * p > occupied_thresh is occupied, p < free_thresh free, otherwise
    unknown (trinary, map_server's -1);
  * image row 0 is the TOP of the map, so rows are flipped into the
    MazeMap's row index == y convention.

Unknown pixels are walls for the filter by default (rays stop at the
explored frontier and the validity stencil keeps particles out of
unexplored space); unknown="free" makes them free.  `from_pgm` builds the
map through grid.from_raster, whose synthesized wall tensor serves the
cell layer.
"""
from __future__ import annotations

import os.path as osp
import re
from typing import Optional

import numpy as np

from ..config import GridConfig
from . import grid


def load_pgm(path: str) -> np.ndarray:
    """A PGM image (P5 binary or P2 ASCII) as uint8 [H, W]; values are
    rescaled to 0..255 when maxval != 255, and 16-bit P5 is big-endian."""
    with open(path, "rb") as f:
        data = f.read()
    # Header tokens: magic, width, height, maxval, with # comments anywhere
    # between them.
    tokens = []
    pos = 0
    token = re.compile(rb"\s*(#[^\n]*\n|\S+)")
    while len(tokens) < 4:
        m = token.match(data, pos)
        if m is None:
            raise ValueError(f"{path}: truncated PGM header")
        pos = m.end()
        if not m.group(1).startswith(b"#"):
            tokens.append(m.group(1))
    magic = tokens[0]
    if magic not in (b"P2", b"P5"):
        raise ValueError(f"{path}: not a PGM file (magic {magic!r})")
    width, height, maxval = (int(t) for t in tokens[1:])
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: bad maxval {maxval}")
    if magic == b"P5":
        # Exactly one whitespace byte separates maxval from the raster.
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        raster = np.frombuffer(data, dtype=dtype, count=width * height,
                               offset=pos + 1)
    else:
        raster = np.array(data[pos:].split()[: width * height],
                          dtype=np.int64)
        if raster.size != width * height:
            raise ValueError(f"{path}: truncated P2 raster")
    img = raster.reshape(height, width).astype(np.float64)
    if maxval != 255:
        img = img * (255.0 / maxval)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def save_pgm(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] image as binary PGM (P5)."""
    img = np.asarray(img, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def parse_map_yaml(path: str) -> dict:
    """A map_server YAML file as a dict: PyYAML where it is installed,
    else a parser of the map_server schema (scalars and one-line
    [x, y, yaw] lists)."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml  # type: ignore
    except ImportError:
        yaml = None
    if yaml is not None:
        doc = yaml.safe_load(text)
        if not isinstance(doc, dict):
            raise ValueError(f"{path}: expected a YAML mapping")
        return doc
    doc = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        key, val = (s.strip() for s in line.split(":", 1))
        if val.startswith("[") and val.endswith("]"):
            doc[key] = [float(v) for v in val[1:-1].split(",") if v.strip()]
            continue
        for cast in (int, float):
            try:
                doc[key] = cast(val)
                break
            except ValueError:
                pass
        else:
            doc[key] = val.strip("'\"")
    return doc


def occupancy_from_image(img: np.ndarray, negate: bool = False,
                         occupied_thresh: float = 0.65,
                         free_thresh: float = 0.196) -> np.ndarray:
    """uint8 image -> trinary int8 occupancy (100 wall, 0 free, -1
    unknown), with no vertical flip (`from_pgm` flips)."""
    v = np.asarray(img, dtype=np.float64)
    p = v / 255.0 if negate else (255.0 - v) / 255.0
    out = np.full(v.shape, -1, dtype=np.int8)
    out[p > occupied_thresh] = 100
    out[p < free_thresh] = 0
    return out


def to_pgm_image(occ: np.ndarray) -> np.ndarray:
    """Binary or trinary occupancy -> map_server image rows, top row
    first: walls 0 (black), free 254, unknown 205."""
    occ = np.asarray(occ)
    img = np.where(occ > 0, 0, np.where(occ < 0, 205, 254)).astype(np.uint8)
    return img[::-1]


def export_raster(occ, resolution: float, origin_x: float, origin_y: float,
                  pgm_path: str, yaml_path: Optional[str] = None) -> None:
    """Write an occupancy raster (> 0 wall, < 0 unknown, 0 free) as a
    map_server PGM, and its YAML when `yaml_path` is given."""
    save_pgm(pgm_path, to_pgm_image(np.asarray(occ)))
    if yaml_path is not None:
        with open(yaml_path, "w") as f:
            f.write(
                "image: %s\nresolution: %s\norigin: [%s, %s, 0.0]\n"
                "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n"
                % (osp.basename(pgm_path), resolution, origin_x, origin_y))


def export_map(m: "grid.MazeMap", pgm_path: str,
               yaml_path: Optional[str] = None) -> None:
    """Write a single map's raster as map_server PGM (+ YAML), the inverse
    of `from_pgm`."""
    occ = m.occ.detach().cpu().numpy().astype(np.int8) * 100
    export_raster(occ, m.resolution, m.origin_x, m.origin_y, pgm_path,
                  yaml_path)


def from_pgm(yaml_path: str, cell_meters: Optional[float] = None,
             unknown: str = "occupied", keep_origin: bool = False,
             grid_cfg: GridConfig = GridConfig(),
             device="cuda") -> "grid.MazeMap":
    """A map_server YAML + PGM pair as a MazeMap on `device`.

    unknown: "occupied" (default) or "free".  keep_origin: by default the
    map sits in its local frame (origin (0, 0), the reference's
    convention); True keeps the YAML origin, which the filter core (cast,
    likelihood, validity) respects and the cell layer does not.
    cell_meters: the pitch of the synthesized cell lattice (default
    grid_cfg.cell_meters, the reference's 0.8 m)."""
    doc = parse_map_yaml(yaml_path)
    for key in ("image", "resolution"):
        if key not in doc:
            raise ValueError(f"{yaml_path}: missing '{key}'")
    img_path = doc["image"]
    if not osp.isabs(img_path):
        img_path = osp.join(osp.dirname(osp.abspath(yaml_path)), img_path)
    tri = occupancy_from_image(
        load_pgm(img_path), negate=bool(doc.get("negate", 0)),
        occupied_thresh=float(doc.get("occupied_thresh", 0.65)),
        free_thresh=float(doc.get("free_thresh", 0.196)))[::-1]
    if unknown == "occupied":
        occ = tri != 0
    elif unknown == "free":
        occ = tri > 0
    else:
        raise ValueError(f"unknown= must be 'occupied' or 'free', "
                         f"got {unknown!r}")
    origin = doc.get("origin", [0.0, 0.0, 0.0])
    if keep_origin and len(origin) > 2 and abs(float(origin[2])) > 1e-9:
        raise ValueError("rotated map origins (yaw != 0) are not supported")
    return grid.from_raster(
        occ, resolution=float(doc["resolution"]),
        origin_x=float(origin[0]) if keep_origin else 0.0,
        origin_y=float(origin[1]) if keep_origin else 0.0,
        cell_meters=(grid_cfg.cell_meters if cell_meters is None
                     else float(cell_meters)),
        device=device)
