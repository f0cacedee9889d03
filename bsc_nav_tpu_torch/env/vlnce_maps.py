"""VLN-CE top-down map measure with MP3D connectivity-graph overlays.

Copy of ``bsc_nav_tpu/env/vlnce_maps.py``, which imports no JAX; the
port keeps its own so that it imports nothing of the JAX package
(``tests/test_torch_host_copies.py`` holds the two equal).

Re-creation of the reference's `TopDownMapVLNCE` measure and its helpers
(reference vlnce_maps.py:311-621): an indicator-indexed top-down map with

  * MP3D connectivity-graph nodes drawn on the starting floor,
  * nearest-node tracking constrained to graph EDGES (the agent can only
    "advance" to a node adjacent to the previous nearest node,
    vlnce_maps.py:331-352),
  * node-traversal polylines and an agent trajectory drawn in a
    step-gradient color (vlnce_maps.py:535-614),
  * FOV fog-of-war reveal, straight shortest-path / reference-path /
    source / target overlays (vlnce_maps.py:419-497),
  * a metric dict {map, fog_of_war_mask, agent_map_coord, agent_angle,
    bounds, meters_per_px} (vlnce_maps.py:500-520).

Differences from the reference: no cv2/networkx/habitat dependency — the
connectivity graph is a plain dataclass loadable from the *raw* MP3D
`<scan>_connectivity.json` format (pose matrices + unobstructed adjacency),
from a simple JSON dict, or from the reference's pickled networkx graphs
when networkx is importable; drawing uses numpy Bresenham; the JET
colormap is computed, not looked up.  The map backend is any
`GridPathfinder`-like object (nav grid + world<->cell transform), so the
measure works on both the fake world and the habitat backend.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# indicator palette indices (reference vlnce_maps.py:636-645)
MAP_INVALID_POINT = 0
MAP_VALID_POINT = 1
MAP_BORDER_INDICATOR = 2
MAP_SOURCE_POINT_INDICATOR = 4
MAP_TARGET_POINT_INDICATOR = 6
MAP_SHORTEST_PATH_COLOR = 7
MAP_VIEW_POINT_INDICATOR = 8
MAP_TARGET_BOUNDING_BOX = 9
MAP_REFERENCE_POINT = 10
MAP_MP3D_WAYPOINT = 11
GRADIENT_START = 15


# ---------------------------------------------------------------------------
# connectivity graph
# ---------------------------------------------------------------------------

@dataclass
class ConnectivityGraph:
    """Plain MP3D nav-graph: node id -> 3D position + undirected edges."""

    positions: Dict[str, np.ndarray] = field(default_factory=dict)
    edges: Dict[str, List[str]] = field(default_factory=dict)

    def add_node(self, nid: str, position) -> None:
        self.positions[nid] = np.asarray(position, np.float64)
        self.edges.setdefault(nid, [])

    def add_edge(self, a: str, b: str) -> None:
        if b not in self.edges.setdefault(a, []):
            self.edges[a].append(b)
        if a not in self.edges.setdefault(b, []):
            self.edges[b].append(a)

    def neighbors(self, nid: str) -> List[str]:
        return self.edges.get(nid, [])

    def __iter__(self):
        return iter(self.positions)

    def __len__(self):
        return len(self.positions)

    # -- loaders -------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict) -> "ConnectivityGraph":
        """{"nodes": {id: [x,y,z]}, "edges": [[a,b], ...]}"""
        g = cls()
        for nid, pos in d["nodes"].items():
            g.add_node(nid, pos)
        for a, b in d.get("edges", []):
            g.add_edge(a, b)
        return g

    @classmethod
    def from_json(cls, path: str) -> "ConnectivityGraph":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_mp3d_connectivity(cls, path: str) -> "ConnectivityGraph":
        """Parse the raw Matterport3D `<scan>_connectivity.json`: a list of
        viewpoint entries with `image_id`, a row-major 4x4 `pose` whose
        translation sits at indices (3, 7, 11), an `unobstructed` boolean
        adjacency list, and an `included` flag.  This is the format the
        reference pre-bakes into `connectivity_graphs.pkl`
        (vlnce_maps.py:398-400)."""
        with open(path) as f:
            entries = json.load(f)
        g = cls()
        ids = [e["image_id"] for e in entries]
        for e in entries:
            if not e.get("included", True):
                continue
            p = e["pose"]
            # MP3D poses are z-up; habitat is y-up: (x, z, -y)
            g.add_node(e["image_id"],
                       [p[3], p[11], -p[7]])
        for e in entries:
            if not e.get("included", True):
                continue
            for j, ok in enumerate(e.get("unobstructed", [])):
                if ok and j < len(ids) and ids[j] in g.positions:
                    g.add_edge(e["image_id"], ids[j])
        return g

    @classmethod
    def from_networkx(cls, nxg) -> "ConnectivityGraph":
        """Adapt a networkx graph with node attr `position` (the pickled
        format the reference loads, vlnce_maps.py:398-400)."""
        g = cls()
        for nid in nxg.nodes:
            g.add_node(nid, nxg.nodes[nid]["position"])
        for a, b in nxg.edges:
            g.add_edge(a, b)
        return g


def sample_connectivity_graph(pf, spacing_m: float = 1.0
                              ) -> ConnectivityGraph:
    """Build an MP3D-style nav-graph from a navgrid: lattice nodes every
    `spacing_m` on navigable cells, 8-neighbor edges when the straight
    segment between the nodes stays navigable.  Stands in for the real
    MP3D connectivity files on the fake world / habitat scenes without
    connectivity data."""
    g = ConnectivityGraph()
    step = max(int(round(spacing_m / pf.res)), 1)
    H, W = pf.nav.shape
    idx = {}
    for i in range(step // 2, H, step):
        for j in range(step // 2, W, step):
            if pf.nav[i, j]:
                nid = f"{i}_{j}"
                g.add_node(nid, pf.cell_to_world(i, j))
                idx[(i, j)] = nid

    def clear(a, b):
        n = max(abs(b[0] - a[0]), abs(b[1] - a[1])) + 1
        ii = np.linspace(a[0], b[0], n).round().astype(int)
        jj = np.linspace(a[1], b[1], n).round().astype(int)
        return bool(pf.nav[ii, jj].all())

    for (i, j), nid in idx.items():
        for di, dj in ((0, step), (step, 0), (step, step), (step, -step)):
            other = idx.get((i + di, j + dj))
            if other is not None and clear((i, j), (i + di, j + dj)):
                g.add_edge(nid, other)
    return g


def get_nearest_node(graph: ConnectivityGraph, xz: Sequence[float]) -> str:
    """Closest node to an (x, z) position over the WHOLE graph
    (reference vlnce_maps.py:311-328; used once per episode reset)."""
    xz = np.asarray(xz, np.float64)
    best, best_d = None, math.inf
    for nid, pos in graph.positions.items():
        d = float(np.hypot(pos[0] - xz[0], pos[2] - xz[1]))
        if d < best_d:
            best, best_d = nid, d
    return best


def update_nearest_node(graph: ConnectivityGraph, nearest: str,
                        xz: Sequence[float]) -> str:
    """Closest node among {current} U neighbors(current): the nearest node
    may only advance along graph edges (reference vlnce_maps.py:331-352)."""
    xz = np.asarray(xz, np.float64)
    best, best_d = None, math.inf
    for nid in [nearest] + graph.neighbors(nearest):
        pos = graph.positions[nid]
        d = float(np.hypot(pos[0] - xz[0], pos[2] - xz[1]))
        if d < best_d:
            best, best_d = nid, d
    return best


# ---------------------------------------------------------------------------
# numpy drawing primitives (reference vlnce_maps.py:139-206 without cv2)
# ---------------------------------------------------------------------------

def draw_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int],
              value: int, thickness: int = 1) -> None:
    """Bresenham polyline with square-brush thickness; points are (i, j)."""
    i0, j0 = int(p0[0]), int(p0[1])
    i1, j1 = int(p1[0]), int(p1[1])
    n = max(abs(i1 - i0), abs(j1 - j0)) + 1
    ii = np.linspace(i0, i1, n).round().astype(int)
    jj = np.linspace(j0, j1, n).round().astype(int)
    t = max(int(thickness) // 2, 0)
    H, W = img.shape[:2]
    for di in range(-t, t + 1):
        for dj in range(-t, t + 1):
            ci = np.clip(ii + di, 0, H - 1)
            cj = np.clip(jj + dj, 0, W - 1)
            img[ci, cj] = value


def draw_point(img: np.ndarray, ij: Tuple[int, int], value: int,
               radius: int = 1) -> None:
    i, j = int(ij[0]), int(ij[1])
    H, W = img.shape[:2]
    img[max(i - radius, 0):min(i + radius + 1, H),
        max(j - radius, 0):min(j + radius + 1, W)] = value


def _jet(u: np.ndarray) -> np.ndarray:
    """u in [0,1] -> RGB jet colormap (replaces cv2.COLORMAP_JET)."""
    r = np.clip(1.5 - np.abs(4 * u - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * u - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * u - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def topdown_palette() -> np.ndarray:
    """256x3 palette: indicators 0..9 fixed colors, 10.. a jet gradient
    (reference vlnce_maps.py:646-659)."""
    pal = np.full((256, 3), 150, np.uint8)
    pal[GRADIENT_START:] = _jet(
        np.linspace(0.0, 1.0, 256 - GRADIENT_START))
    pal[MAP_INVALID_POINT] = [255, 255, 255]
    pal[MAP_VALID_POINT] = [150, 150, 150]
    pal[MAP_BORDER_INDICATOR] = [50, 50, 50]
    pal[MAP_SOURCE_POINT_INDICATOR] = [0, 0, 200]
    pal[MAP_TARGET_POINT_INDICATOR] = [200, 0, 0]
    pal[MAP_SHORTEST_PATH_COLOR] = [0, 200, 0]
    pal[MAP_VIEW_POINT_INDICATOR] = [245, 150, 150]
    pal[MAP_TARGET_BOUNDING_BOX] = [0, 175, 0]
    pal[MAP_REFERENCE_POINT] = [0, 135, 0]
    pal[MAP_MP3D_WAYPOINT] = [121, 169, 200]
    return pal


_PALETTE = topdown_palette()


def colorize_topdown_map(ind_map: np.ndarray,
                         fog_mask: Optional[np.ndarray] = None,
                         fog_darken: float = 0.5) -> np.ndarray:
    """Indicator map -> RGB; unexplored area darkened (reference
    vlnce_maps.py:95-114)."""
    rgb = _PALETTE[ind_map]
    if fog_mask is not None:
        dark = (rgb.astype(np.float32) * fog_darken).astype(np.uint8)
        keep = (fog_mask > 0) | (ind_map != MAP_VALID_POINT)
        rgb = np.where(keep[..., None], rgb, dark)
    return rgb


# ---------------------------------------------------------------------------
# the measure
# ---------------------------------------------------------------------------

class TopDownMapVLNCE:
    """VLN-CE top-down map over a GridPathfinder-like backend.

    `pathfinder` must expose `.nav` (bool [H, W]), `.res` (meters/cell),
    `.world_to_cell(p) -> (i, j)`, and `.shortest_path(a, b)`.
    """

    def __init__(self, pathfinder, graph: Optional[ConnectivityGraph] = None,
                 visibility_dist: float = 5.0, fov_deg: float = 90.0,
                 trail_thickness: int = 1, floor_tol: float = 1.0):
        self.pf = pathfinder
        self.graph = graph
        self.vis_cells = max(int(visibility_dist / pathfinder.res), 1)
        self.fov = math.radians(fov_deg)
        self.trail_thickness = trail_thickness
        self.floor_tol = floor_tol
        self._map: Optional[np.ndarray] = None
        self._fog: Optional[np.ndarray] = None

    # -- construction ---------------------------------------------------------
    def _base_map(self) -> np.ndarray:
        nav = self.pf.nav
        m = np.where(nav, MAP_VALID_POINT, MAP_INVALID_POINT).astype(np.uint8)
        # border = valid cell with an invalid 4-neighbor (draw_border=True)
        pad = np.pad(nav, 1, constant_values=False)
        interior = (pad[:-2, 1:-1] & pad[2:, 1:-1]
                    & pad[1:-1, :-2] & pad[1:-1, 2:])
        m[nav & ~interior] = MAP_BORDER_INDICATOR
        return m

    def reset(self, start_position, goal_position, start_yaw: float = 0.0,
              reference_path: Optional[Iterable] = None) -> None:
        """Rebuild the map with all static overlays
        (reference vlnce_maps.py:419-497)."""
        self._step = 0
        self._map = self._base_map()
        self._fog = np.zeros(self._map.shape, np.uint8)

        a_ij = self.pf.world_to_cell(start_position)
        g_ij = self.pf.world_to_cell(goal_position)
        self._prev_ij = a_ij
        self._reveal(a_ij, start_yaw)

        # MP3D nodes on the starting floor (vlnce_maps.py:355-378)
        if self.graph is not None and len(self.graph):
            n0 = get_nearest_node(self.graph,
                                  (start_position[0], start_position[2]))
            floor_y = self.graph.positions[n0][1]
            for nid in self.graph:
                pos = self.graph.positions[nid]
                if abs(pos[1] - floor_y) < self.floor_tol:
                    i, j = self.pf.world_to_cell(pos)
                    if (0 <= i < self._map.shape[0]
                            and 0 <= j < self._map.shape[1]
                            and self._map[i, j] != MAP_INVALID_POINT):
                        draw_point(self._map, (i, j), MAP_MP3D_WAYPOINT)
            self._nearest_node = n0
            self._node_ij = self.pf.world_to_cell(self.graph.positions[n0])
        else:
            self._nearest_node = None
            self._node_ij = None

        # straight shortest path start -> goal (vlnce_maps.py:247-266)
        path = self.pf.shortest_path(np.asarray(start_position, np.float64),
                                     np.asarray(goal_position, np.float64))
        if path:
            pts = [self.pf.world_to_cell(p) for p in path]
            for p0, p1 in zip(pts[:-1], pts[1:]):
                draw_line(self._map, p0, p1, MAP_SHORTEST_PATH_COLOR)

        # annotated reference path (vlnce_maps.py:208-244)
        if reference_path is not None:
            rp = [self.pf.world_to_cell(p) for p in reference_path]
            for p0, p1 in zip(rp[:-1], rp[1:]):
                draw_line(self._map, p0, p1, MAP_REFERENCE_POINT)

        # source and target last to avoid overlap (vlnce_maps.py:269-287)
        draw_point(self._map, a_ij, MAP_SOURCE_POINT_INDICATOR, radius=2)
        draw_point(self._map, g_ij, MAP_TARGET_POINT_INDICATOR, radius=2)

    # -- per-step update ------------------------------------------------------
    def _reveal(self, ij: Tuple[int, int], yaw: float) -> None:
        """FOV wedge fog-of-war reveal (fog_of_war.reveal_fog_of_war role)."""
        n = self.vis_cells
        i, j = ij
        ii, jj = np.mgrid[-n:n + 1, -n:n + 1]
        ang = np.arctan2(ii, jj)
        fwd = math.atan2(-math.sin(yaw), -math.cos(yaw))
        diff = (ang - fwd + np.pi) % (2 * np.pi) - np.pi
        wedge = (np.hypot(ii, jj) <= n) & (np.abs(diff) <= self.fov / 2)
        ci, cj = np.nonzero(wedge)
        gi = np.clip(ci - n + i, 0, self._fog.shape[0] - 1)
        gj = np.clip(cj - n + j, 0, self._fog.shape[1] - 1)
        self._fog[gi, gj] = 1

    def update(self, position, yaw: float) -> Dict:
        """One agent step: gradient trail, fog reveal, edge-constrained
        nearest-node advance + traversal line (vlnce_maps.py:500-614).
        Returns the metric dict."""
        assert self._map is not None, "call reset() first"
        self._step += 1
        ij = self.pf.world_to_cell(position)
        grad = GRADIENT_START + min(self._step * 245 // 5000, 245 - 5)

        if self._map[ij] != MAP_SOURCE_POINT_INDICATOR:
            draw_line(self._map, self._prev_ij, ij, grad,
                      thickness=self.trail_thickness)
        self._reveal(ij, yaw)

        if self._nearest_node is not None:
            prev = self._nearest_node
            self._nearest_node = update_nearest_node(
                self.graph, prev, (position[0], position[2]))
            if self._nearest_node != prev:
                nij = self.pf.world_to_cell(
                    self.graph.positions[self._nearest_node])
                draw_point(self._map, nij, grad, radius=1)
                draw_line(self._map, self._node_ij, nij, grad,
                          thickness=self.trail_thickness)
                self._node_ij = nij

        self._prev_ij = ij
        return self.metric(position, yaw)

    def metric(self, position, yaw: float) -> Dict:
        ij = self.pf.world_to_cell(position)
        H, W = self.pf.nav.shape
        return {
            "map": self._map,
            "fog_of_war_mask": self._fog,
            "agent_map_coord": ij,
            "agent_angle": float(yaw) + math.pi,
            "bounds": {"lower": np.asarray(self.pf.origin, np.float64),
                       "upper": np.asarray(self.pf.origin, np.float64)
                       + np.asarray([H, W]) * self.pf.res},
            "meters_per_px": self.pf.res,
        }

    def render(self) -> np.ndarray:
        return colorize_topdown_map(self._map, self._fog)
