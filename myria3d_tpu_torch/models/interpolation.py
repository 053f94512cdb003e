"""Full-tile prediction assembly + LAS writing.

Re-design of reference ``Interpolator`` (``myria3d/models/interpolation.py:18-186``):
accumulates per-subtile full-cloud logits (already kNN-interpolated on device
by ``Model.interp_step``) together with each subtile's indices into the
original cloud; merges overlapping predictions by scatter-add over the
original index (reference ``scatter_sum`` logit merging, ``:113-116``); then
derives probabilities / predicted class codes / entropy and writes them into
new LAS dimensions with the source header (SRS/scales/offsets) preserved
(reference PDAL dim-ferry + writer-from-reader-metadata, ``:70-91,176-184``).

Copied from ``myria3d_tpu/models/interpolation.py``; imports point at the port.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np

from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
from myria3d_tpu_torch.pctl.io.las import write_las
from myria3d_tpu_torch.utils import utils
from myria3d_tpu_torch.utils.profiling import count, span

log = utils.get_logger(__name__)


def _nearest_covered(points: np.ndarray, covered: np.ndarray) -> np.ndarray:
    """For each uncovered point, the index of its nearest covered point.

    The uncovered residue is spatially localized (subtile boundary effects
    at ``subtile_overlap=0``), so the cKDTree is built only over covered
    points inside the residue's bounding box expanded by a margin — the
    margin grows until every query's found distance is <= it (which proves
    the true nearest neighbor was among the candidates), so the result is
    exact without ever building a tree over all ~17 M covered points of a
    production tile.

    Returns an int64 array aligned with ``np.flatnonzero(~covered)``.
    """
    from scipy.spatial import cKDTree

    uncov = np.flatnonzero(~covered)
    pos_u = np.stack(
        [points["X"][uncov], points["Y"][uncov], points["Z"][uncov]], axis=1
    )
    x, y, z = points["X"], points["Y"], points["Z"]
    lo, hi = pos_u.min(axis=0), pos_u.max(axis=0)
    margin = 5.0
    while True:
        in_box = (
            covered
            & (x >= lo[0] - margin) & (x <= hi[0] + margin)
            & (y >= lo[1] - margin) & (y <= hi[1] + margin)
            & (z >= lo[2] - margin) & (z <= hi[2] + margin)
        )
        cand = np.flatnonzero(in_box)
        full = len(cand) == int(covered.sum())
        if len(cand) == 0:
            margin *= 4.0
            continue
        pos_c = np.stack([x[cand], y[cand], z[cand]], axis=1)
        d, j = cKDTree(pos_c).query(pos_u, k=1, workers=-1)
        if full or float(d.max()) <= margin:
            return cand[j]
        margin *= 4.0


class Interpolator:
    """Accumulate subtile logits and write the predicted LAS."""

    def __init__(
        self,
        interpolation_k: int = 10,
        classification_dict: Dict[int, str] = {},
        probas_to_save: Optional[Union[List[str], str]] = "all",
        predicted_classification_channel: Optional[str] = "PredictedClassification",
        entropy_channel: Optional[str] = "entropy",
        uncovered_policy: str = "keep",
    ):
        # What happens to points no subtile predicted (artefacts dropped by
        # DropPointsByClass + points of dropped small areas):
        #   "keep"    — reference parity (interpolation.py:155-170 NB notes):
        #               null probas, null entropy, PredictedClassification
        #               keeps the point's ORIGINAL class code.
        #   "nearest" — inherit every channel from the nearest covered
        #               neighbor (opt-in spatial closure; costs one cKDTree
        #               query over the residue at save time).
        if uncovered_policy not in ("keep", "nearest"):
            raise ValueError(
                f"uncovered_policy must be 'keep' or 'nearest', got "
                f"{uncovered_policy!r}"
            )
        self.uncovered_policy = uncovered_policy
        self.k = interpolation_k
        self.classification_dict = classification_dict
        # consecutive model index -> original class code
        self.reverse_mapper = np.asarray(
            list(classification_dict.keys()), dtype=np.int32
        )
        if probas_to_save == "all":
            self.probas_to_save = list(classification_dict.values())
        elif probas_to_save is None:
            self.probas_to_save = []
        else:
            self.probas_to_save = list(probas_to_save)
        self.predicted_classification_channel = predicted_classification_channel
        self.entropy_channel = entropy_channel

        self.logits: List[np.ndarray] = []
        self.idx_in_full_cloud: List[np.ndarray] = []
        self.finalize_phases: Dict[str, float] = {}
        # points merged since prepare() (or construction), by route
        self.merge_counts: Dict[str, int] = {}
        # incremental-merge state (see prepare())
        self._nb_points: Optional[int] = None
        self._reduced: Optional[np.ndarray] = None
        self._covered: Optional[np.ndarray] = None
        self._points: Optional[np.ndarray] = None
        self._header = None

    def prepare(
        self,
        nb_points: int,
        points: Optional[np.ndarray] = None,
        header=None,
    ) -> None:
        """Switch to incremental overlap merging for the coming tile.

        When the tile's point count is known up front (the predict pipeline
        reads the tile once anyway), each batch's logits are scatter-added
        into the final (nb_points, C) plane as they arrive — the merge
        overlaps the device streaming loop instead of running as a
        serial tail after it, and peak memory drops from two copies of the
        tile's logits (per-subtile stash + reduced plane) to one.

        ``points``/``header`` optionally hand over the already-read source
        arrays so ``reduce_predictions_and_save`` skips its own full-tile
        re-read (reference re-reads via PDAL, ``interpolation.py:139``).
        """
        self._nb_points = int(nb_points)
        self._reduced = None  # allocated on first batch (C known then)
        self._covered = np.zeros(self._nb_points, dtype=bool)
        self._points = points
        self._header = header
        self.merge_counts = {}

    @staticmethod
    def _scatter_add(reduced: np.ndarray, idx: np.ndarray, logit: np.ndarray) -> str:
        """Add ``logit``'s rows into ``reduced[idx]``; returns the route
        taken: "native", "fancy" or "add_at"."""
        # Subtile crops index each original point at most once, in
        # ascending order — row ranges are then race-free, so the native
        # thread-parallel row scatter applies (f16 wire logits upcast
        # in-flight, deleting the full-batch astype pass); the vectorized
        # fancy += is the no-toolchain fallback (2.1x np.add.at at the
        # 17 M-point tile scale, measured). Unsorted/duplicated indices
        # fall back to the duplicate-safe ufunc scatter.
        if idx.size < 2 or np.all(np.diff(idx) > 0):
            from myria3d_tpu_torch.pctl.native import native_scatter_add_rows

            logit = np.ascontiguousarray(logit)
            if native_scatter_add_rows(reduced, idx, logit):
                return "native"
            reduced[idx] += logit.astype(np.float32, copy=False)
            return "fancy"
        np.add.at(reduced, idx, logit)
        return "add_at"

    def _merge(self, reduced: np.ndarray, idx: np.ndarray, logit: np.ndarray) -> None:
        """``_scatter_add``, counted in ``merge_counts``: the points merged
        (``merge_points``) and those the native row scatter took
        (``merge_points_native``)."""
        native = self._scatter_add(reduced, idx, logit) == "native"
        count(self.merge_counts, "merge_points", len(idx))
        count(self.merge_counts, "merge_points_native", len(idx) if native else 0)

    def store_predictions(self, logits, idx_in_original_cloud) -> None:
        """Keep a batch's per-point full-subtile logits (host side).

        Args:
            logits: (B, M, C) padded full-cloud logits from ``interp_step``.
            idx_in_original_cloud: list of B int arrays (ragged true lengths).
        """
        # the device ships f16 logits to halve the transfer; the native
        # scatter upcasts in-flight, so only the stash path converts here
        logits = np.asarray(logits)
        if self._nb_points is not None and self._reduced is None:
            self._reduced = np.zeros(
                (self._nb_points, logits.shape[-1]), dtype=np.float32
            )
        for b, idx in enumerate(idx_in_original_cloud):
            if idx is None:
                continue
            n = min(len(idx), logits.shape[1])
            if n < len(idx):
                # should not happen since the padding ladder grows past its
                # top entry; surface it loudly if a caller truncates anyway
                log.warning(
                    f"Subtile logits truncated: {len(idx) - n} of {len(idx)} "
                    "points lose their predictions (padded bucket too small)."
                )
            idx_arr = np.asarray(idx[:n], np.int64)
            if self._reduced is not None:
                self._merge(self._reduced, idx_arr, logits[b, :n])
                self._covered[idx_arr] = True
            else:
                self.logits.append(
                    logits[b, :n].astype(np.float32, copy=False)
                )
                self.idx_in_full_cloud.append(idx_arr)

    def reduce_predicted_logits(self, nb_points: int) -> np.ndarray:
        """Merge overlapping subtile predictions by summing logits per
        original point (reference ``reduce_predicted_logits``, ``:98-121``)."""
        if self._nb_points is not None:
            assert nb_points == self._nb_points, (
                f"prepare() was given {self._nb_points} points but the tile "
                f"has {nb_points}"
            )
            if self._reduced is not None:
                return self._reduced
            # prepared but no batch ever arrived
            return np.zeros((nb_points, len(self.reverse_mapper)), np.float32)
        num_classes = self.logits[0].shape[-1] if self.logits else len(self.reverse_mapper)
        reduced = np.zeros((nb_points, num_classes), dtype=np.float32)
        for logit, idx in zip(self.logits, self.idx_in_full_cloud):
            self._merge(reduced, idx, logit)
        return reduced

    def reduce_predictions_and_save(
        self, raw_path: str, output_dir: str, epsg: Optional[str] = None
    ) -> str:
        """Derive channels from merged logits and write the output LAS
        (reference ``reduce_predictions_and_save``, ``:123-186``).

        Fills ``self.finalize_phases`` with the phase wall-times
        (coverage closure, softmax/entropy, LAS write; the spans
        ``predict.finalize.coverage``, ``.softmax`` and ``.write``) for the
        predict phase table."""
        sums: Dict[str, float] = {}
        with span("predict.finalize.coverage", sums):
            if self._points is not None:
                points, header = self._points, self._header
            else:
                points, header = read_las_array(raw_path, epsg)
            nb_points = len(points)
            logits = self.reduce_predicted_logits(nb_points)

            # Uncovered points = artefacts dropped by DropPointsByClass + points
            # of subtiles dropped as too small. The reference leaves them at
            # null probas / null entropy / their ORIGINAL class code
            # (interpolation.py:155-170, explicit NB comments) — that is the
            # default "keep" policy; "nearest" opts into spatial closure from
            # the nearest covered neighbor instead.
            if self._covered is not None:
                covered = self._covered
            else:
                covered = np.zeros(nb_points, dtype=bool)
                for idx in self.idx_in_full_cloud:
                    covered[idx] = True
            n_uncovered = int(nb_points - covered.sum())
            uncov = None
            if n_uncovered == nb_points:
                log.warning(
                    "No point of the tile was covered by any subtile prediction;"
                    " the output carries source classes and null probabilities."
                )
                uncov = np.arange(nb_points)
            elif n_uncovered:
                log.info(
                    f"{n_uncovered}/{nb_points} points "
                    f"({100.0 * n_uncovered / nb_points:.2f}%) have no subtile "
                    "prediction (dropped artefact classes and/or dropped small "
                    f"areas); policy '{self.uncovered_policy}' applies."
                )
                if self.uncovered_policy == "nearest" and n_uncovered < nb_points:
                    src = _nearest_covered(points, covered)
                    uncov = np.flatnonzero(~covered)
                    logits[uncov] = logits[src]
                    uncov = None  # closed — treat as covered downstream
                else:
                    uncov = np.flatnonzero(~covered)

        # softmax + argmax-map + entropy: fused native single pass when the
        # toolchain is present, else the numpy chain (same math; the native
        # kernel's per-row H = log Z + max - sum(p*logit) mirrors the
        # numpy formulation below bit-for-bit up to libm/fp association)
        with span("predict.finalize.softmax", sums):
            from myria3d_tpu_torch.pctl.native import native_logits_finalize

            fused = native_logits_finalize(
                logits,
                self.reverse_mapper.astype(np.uint8),
                want_preds=bool(self.predicted_classification_channel),
                want_entropy=bool(self.entropy_channel),
            )
            if fused is not None:
                probas, preds, ent = fused
            else:
                # numerically-stable softmax
                m = logits.max(axis=1, keepdims=True)
                e = np.exp(logits - m)
                z = e.sum(axis=1, keepdims=True)
                probas = e / z
                preds = ent = None
                if self.predicted_classification_channel:
                    preds = self.reverse_mapper[np.argmax(probas, axis=1)]
                    preds = preds.astype(np.uint8)
                if self.entropy_channel:
                    # H = log Z + max - sum(p * logit): one log over N instead
                    # of N x C (same value as -sum p log p, exact up to fp assoc)
                    ent = (
                        np.log(z[:, 0])
                        + m[:, 0]
                        - np.einsum("nc,nc->n", probas, logits)
                    ).astype(np.float32)
                    np.maximum(ent, 0.0, out=ent)  # clip fp negatives at one-hot
            if uncov is not None:
                probas[uncov] = 0.0  # reference: null probabilities

        extra_columns: Dict[str, np.ndarray] = {}
        class_names = list(self.classification_dict.values())
        for name in self.probas_to_save:
            ci = class_names.index(name)
            extra_columns[name] = probas[:, ci]
        if preds is not None:
            if uncov is not None and "Classification" in (
                points.dtype.names or ()
            ):
                # reference: unpredicted points keep their original class
                preds[uncov] = points["Classification"][uncov].astype(np.uint8)
            extra_columns[self.predicted_classification_channel] = preds
        if ent is not None:
            if uncov is not None:
                ent[uncov] = 0.0  # reference: null entropy
            extra_columns[self.entropy_channel] = ent

        with span("predict.finalize.write", sums):
            os.makedirs(output_dir, exist_ok=True)
            out_path = os.path.join(output_dir, os.path.basename(raw_path))
            # atomic publish: an existing output file is always complete, so
            # predict.resume can trust it (a preemption mid-write leaves only
            # the temp file, overwritten on the redo). The temp name keeps the
            # original suffix — write_las picks LAZ compression by extension.
            # The new dims ride as extra_columns so no intermediate widened
            # record array is ever built (one less full-tile strided ferry).
            tmp_path = os.path.join(
                output_dir, ".tmp." + os.path.basename(raw_path)
            )
            write_las(
                tmp_path, points, header=header, extra_dims="all",
                extra_columns=extra_columns,
            )
            os.replace(tmp_path, out_path)
        self.finalize_phases = {
            name.rsplit(".", 1)[1] + "_s": round(t, 2) for name, t in sums.items()
        }
        log.info(f"Predictions written to {out_path}")

        # reset accumulators for the next tile
        self.logits = []
        self.idx_in_full_cloud = []
        self._nb_points = None
        self._reduced = None
        self._covered = None
        self._points = None
        self._header = None
        return out_path
