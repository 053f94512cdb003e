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
A tile starts with ``prepare``; each batch's overlap merge
(``store_predictions``) is one native call for any index order, bit-equal to the original's ``np.add.at``,
and the softmax, class and entropy go with the record pack into one native
pass whose threads write the output file
(``pctl.io.las.write_las_predictions``), byte for byte the original's file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np

from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
from myria3d_tpu_torch.pctl.io.las import write_las_predictions
from myria3d_tpu_torch.pctl.native import native_scatter_add_rows
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

        self.finalize_phases: Dict[str, float] = {}
        # the finalize pass's seconds in its writes, averaged over its
        # threads, and their count ("write_io_s", "write_threads")
        self.write_stats: Dict[str, float] = {}
        # points merged since prepare() ("merge_points")
        self.merge_counts: Dict[str, int] = {}
        # the tile's merge state (see prepare())
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
        """Start a tile of ``nb_points`` points: the only way in.

        Each batch's logits are scatter-added into the tile's (nb_points, C)
        plane as they arrive, so the merge overlaps the device streaming
        loop instead of running as a serial tail after it.

        ``points``/``header`` optionally hand over the already-read source
        arrays so ``reduce_predictions_and_save`` skips its own full-tile
        re-read (reference re-reads via PDAL, ``interpolation.py:139``).
        """
        self._nb_points = int(nb_points)
        # allocated on the first batch (C known then)
        self._reduced = None
        self._covered = None
        self._points = points
        self._header = header
        self.merge_counts = {}

    def _require_prepared(self) -> None:
        if self._nb_points is None:
            raise RuntimeError("Interpolator: call prepare(nb_points) before each tile")

    def store_predictions(self, logits, idx_in_original_cloud) -> None:
        """Merge a batch's per-point full-subtile logits into the tile's
        plane, ``reduced[idx] += logits[b, :len(idx)]`` subtile by subtile,
        and mark ``covered[idx]``, by one native call for the batch: any
        index order, repeats included, bit-equal to ``np.add.at``. Counts
        the points merged in ``merge_counts["merge_points"]``.

        Args:
            logits: (B, M, C) padded full-cloud logits from ``interp_step``.
            idx_in_original_cloud: list of B int arrays (ragged true lengths).
        """
        self._require_prepared()
        # the device ships f16 logits to halve the transfer; the native
        # scatter upcasts them in flight
        logits = np.asarray(logits)
        zero = self._reduced is None
        if zero:
            # zeroed by the merge's own threads, each its rows in order
            self._reduced = np.empty((self._nb_points, logits.shape[-1]), dtype=np.float32)
            self._covered = np.empty(self._nb_points, dtype=bool)
        idxs, rows = [], []
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
            idxs.append(np.asarray(idx[:n], np.int64))
            rows.append(np.ascontiguousarray(logits[b, :n]))
        native_scatter_add_rows(self._reduced, idxs, rows, covered=self._covered, zero=zero)
        count(self.merge_counts, "merge_points", sum(len(idx) for idx in idxs))

    def reduce_predicted_logits(self, nb_points: int) -> np.ndarray:
        """The merged logits: overlapping subtile predictions summed per
        original point (reference ``reduce_predicted_logits``, ``:98-121``);
        a zero plane when no batch reached the tile."""
        self._require_prepared()
        assert nb_points == self._nb_points, (
            f"prepare() was given {self._nb_points} points but the tile "
            f"has {nb_points}"
        )
        if self._reduced is None:
            return np.zeros((nb_points, len(self.reverse_mapper)), np.float32)
        return self._reduced

    def reduce_predictions_and_save(
        self, raw_path: str, output_dir: str, epsg: Optional[str] = None
    ) -> str:
        """Derive channels from merged logits and write the output LAS
        (reference ``reduce_predictions_and_save``, ``:123-186``).

        Fills ``self.finalize_phases`` with the phase wall-times for the
        predict phase table: the spans ``predict.finalize.coverage`` (the
        coverage closure), ``.softmax`` (the new dims and the class map) and
        ``.write`` (the one pass that computes the softmax, class and
        entropy, packs the records and writes them, and the publish); and
        ``self.write_stats`` with the pass's seconds in its writes, averaged
        over its threads, and their count (``write_io_s``,
        ``write_threads``)."""
        self._require_prepared()
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
            covered = self._covered if self._covered is not None else np.zeros(nb_points, bool)
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

        with span("predict.finalize.softmax", sums):
            # the new dims in write_las's order (a name given twice keeps its
            # first place and its last kind): probabilities, class, entropy
            class_names = list(self.classification_dict.values())
            channels: Dict[str, Union[int, str]] = {
                name: class_names.index(name) for name in self.probas_to_save}
            if self.predicted_classification_channel:
                channels[self.predicted_classification_channel] = "class"
            if self.entropy_channel:
                channels[self.entropy_channel] = "entropy"
            class_map = self.reverse_mapper.astype(np.uint8)

        # softmax, class code and entropy, packed with the points' records
        # and written by the pass's threads (reference: null probabilities
        # and entropy and the original class where no subtile predicted)
        with span("predict.finalize.write", sums):
            os.makedirs(output_dir, exist_ok=True)
            out_path = os.path.join(output_dir, os.path.basename(raw_path))
            # atomic publish: an existing output file is always complete, so
            # predict.resume can trust it (a preemption mid-write leaves only
            # the temp file, overwritten on the redo). The temp name keeps the
            # original suffix — the writer picks LAZ compression by extension.
            tmp_path = os.path.join(
                output_dir, ".tmp." + os.path.basename(raw_path)
            )
            io_s, threads = write_las_predictions(
                tmp_path, points, header, logits, covered if uncov is not None else None,
                class_map, channels,
            )
            os.replace(tmp_path, out_path)
        self.finalize_phases = {
            name.rsplit(".", 1)[1] + "_s": round(t, 2) for name, t in sums.items()
        }
        self.write_stats = {"write_io_s": round(io_s, 2), "write_threads": threads}
        log.info(f"Predictions written to {out_path}")

        # the next tile starts with its own prepare()
        self._nb_points = None
        self._reduced = None
        self._covered = None
        self._points = None
        self._header = None
        return out_path
