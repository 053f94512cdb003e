"""Whole tiles through ``myria3d_tpu_torch.predict.predict``, back to back.

Set-up writes the seed's tile (``gen.write_tile``) and saves the seeded
weights as a checkpoint, both in a directory of their own under ``TMPDIR``
that the run deletes at its end (so every run does the same set-up work,
whatever an earlier run left), composes the predict configuration (``experiment=predict``
with the traffic's settings, each checked against what the cell states),
and warms up what a tile runs: the tile read, the cook and one step of the
cell's bucket, the merge's and the writer's native code.

The window predicts the tile again and again, reading the next one ahead
in a thread as ``run.launch_predict`` does with ``prefetch_tiles: 1``; each
output goes to the same path in that directory. It closes at the end of the
first tile that ends after ``--seconds`` with at least ``min_tiles`` done;
the rate is every point of every tile over the whole window.

The check, once the window has closed and the program's state is freed:
one batch of the tile, drawn from the seed, is cooked by the reference from
the tile file, run through the reference net with the program's generator
replayed to that batch, interpolated, rounded to float16 as the program
ships logits, and compared with the last output at every point of those
subtiles that lies in one subtile only (a point on a border is the sum of
two subtiles' logits).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perfbench import compare, gen, las, weights
from perfbench.drivers.common import Ctx, build_program_model, tf32
from perfbench.reference import cook, search

def window_closes(elapsed_s: float, tiles: int, seconds: float, min_tiles: int) -> bool:
    """Whether the window closes after a tile that ended ``elapsed_s`` into
    it, with ``tiles`` tiles done: past ``seconds`` and ``min_tiles``."""
    return elapsed_s >= seconds and tiles >= min_tiles


def predict_config(ctx: Ctx, tile: str, ckpt: str, out_dir: str) -> dict:
    """The predict configuration of the program's CLI with the traffic's
    overrides; raises if it does not state what the cell measures."""
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    tr = ctx.traffic
    cfg = compose_config(CONFIG_DIR, "config.yaml", [
        "task.task_name=predict", f"predict.src_las={tile}", f"predict.output_dir={out_dir}",
        f"predict.ckpt_path={ckpt}", *tr["overrides"]])
    want = {("predict", "sorted_window"): tr["sorted_window"],
            ("predict", "subtile_overlap"): 0,
            ("datamodule", "batch_size"): tr["rows"],
            ("datamodule", "subtile_width"): tr["subtile_width"],
            ("datamodule", "tile_width"): tr["tile_width"]}
    for (sec, key), value in want.items():
        if cfg[sec].get(key) != value:
            raise ValueError(f"{sec}.{key} is {cfg[sec].get(key)!r}, the cell states {value!r}")
    itp = cfg["predict"]["interpolator"]
    if itp["interpolation_k"] != ctx.config["interpolation_k"] or itp["probas_to_save"] != "all":
        raise ValueError(f"interpolator {itp} is not the cell's")
    return cfg


def warm_up(config: dict, model, points) -> None:
    """One batch of the cell's bucket through the cook, the step and the
    merge, and the native writer, outside the window."""
    from myria3d_tpu_torch.models.interpolation import Interpolator
    from myria3d_tpu_torch.pctl.batching import pad_full_cloud, pad_sampled_pos
    from myria3d_tpu_torch.predict import tile_loader

    dev = next(model.parameters()).device
    batch = next(iter(tile_loader(config, points)))
    full = pad_full_cloud(batch.copies)
    args = [torch.from_numpy(a).to(dev) for a in (
        batch.x, batch.pos, batch.mask, pad_sampled_pos(batch.copies, batch.num_points),
        full["full_pos"], full["full_mask"])]
    model.set_sorted_window(config["predict"]["sorted_window"])
    logits = model.interp_step(*args, torch.Generator(device=dev).manual_seed(0)).cpu()
    itp = Interpolator(classification_dict={1: "a", 2: "b", 3: "c", 4: "d", 5: "e", 6: "f",
                                            7: "g"})
    itp.prepare(len(points))
    itp.store_predictions(logits.numpy(), batch.idx_in_original_cloud)


def run(ctx: Ctx) -> dict:
    work = tempfile.mkdtemp(prefix="perfbench_tile_")
    try:
        tile = os.path.join(work, "tile.las")
        gen.write_tile(tile, ctx.traffic, ctx.seed)
        ctx.mark("tile written")
        return _run(ctx, tile, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(ctx: Ctx, tile: str, work: str) -> dict:
    from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
    from myria3d_tpu_torch.predict import predict, tile_loader

    tr, cuda = ctx.traffic, ctx.device.type == "cuda"
    w = weights.make(ctx.reference.param_shapes(ctx.config["neural_net_hparams"]), ctx.seed,
                     ctx.device)
    model = build_program_model(ctx, w).eval()
    ckpt = model.save_checkpoint(os.path.join(work, "ckpt"))
    out_dir = os.path.join(work, "out")
    config = predict_config(ctx, tile, ckpt, out_dir)
    ctx.mark("checkpoint and configuration")
    epsg = config["datamodule"].get("epsg")
    reader = ThreadPoolExecutor(max_workers=1)
    try:
        ahead = [reader.submit(read_las_array, tile, epsg)]
        points = ahead[0].result()[0]
        ctx.mark("tile read")
        warm_up(config, model, points)
        del model, points
        ahead.append(reader.submit(read_las_array, tile, epsg))
        ctx.sync()
        ctx.mark("warm-up")
        setup_s = ctx.since_start()

        phases, n_points, ends = [], 0, []
        trace = None
        t0 = time.perf_counter()
        while True:
            ph: dict = {}
            j = len(phases)
            if ctx.trace and j == 0:
                from perfbench.devtrace import profiled

                box = []
                trace = profiled(lambda: box.append(predict(config, phases=ph, preread=ahead[j])),
                                 ctx.sync, on_cpu=not cuda)
                out_path = box[0]
            else:
                out_path = predict(config, phases=ph, preread=ahead[j])
            n_points += len(ahead[j].result()[0])
            ahead[j] = None
            phases.append(ph)
            ends.append(time.perf_counter() - t0)
            if window_closes(ends[-1], len(phases), ctx.seconds, tr["min_tiles"]):
                break
            ahead.append(reader.submit(read_las_array, tile, epsg))
        window_s = time.perf_counter() - t0
    finally:
        reader.shutdown(wait=True)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    print(f"tiles end (s into the window): {[round(t, 3) for t in ends]}", file=sys.stderr)
    record = {"phases": phases, "trace": trace}
    if ctx.trace:
        points = read_las_array(tile, epsg)[0]
        t1 = time.perf_counter()
        for _ in tile_loader(config, points):
            pass
        record["cook_s"] = time.perf_counter() - t1
        del points
    if cuda:
        torch.cuda.empty_cache()

    readings, lower = check(ctx, w, tile, out_path, config)
    os.remove(out_path)
    e2e = {"tile_mpts_per_s": n_points / window_s / 1e6, "setup_s": setup_s}
    return {"e2e": e2e, "record": record, "readings": readings, "attempted": len(phases),
            "memory_peak_bytes": peak, "trace": trace, "control_readings": lower}


def check(ctx: Ctx, w: dict, tile: str, out_path: str, config: dict):
    """(readings, control readings) of the batch the seed draws."""
    tr = ctx.traffic
    pts = las.read_fmt8(tile)
    squares, member = cook.windows(pts["X"], pts["Y"], tr["tile_width"], tr["subtile_width"])
    rows = tr["rows"]
    n_batches = -(-len(squares) // rows)
    pick = int(np.random.default_rng(ctx.seed).integers(n_batches))
    # the program's generator, replayed to the picked batch: each earlier
    # batch's forward drew one decimation a block at that batch's bucket
    g = torch.Generator(device=ctx.device).manual_seed(int(config.get("seed", 12345)))
    net_cfg = dict(ctx.config["neural_net_hparams"], knn_window=tr["sorted_window"])
    for bi in range(pick):
        n_max = 0
        for idx in squares[bi * rows:(bi + 1) * rows]:
            pos, _, cls = cook.features(pts, idx)
            n_max = max(n_max, cook.sampled_count(pos, cls, tr["voxel"]))
        mask = torch.zeros((rows, cook.bucket(n_max, cook.SAMPLED_BUCKETS)), dtype=torch.bool,
                           device=ctx.device)
        for _ in range(4):
            mask = search.random_decimation(mask, net_cfg["decimation"], g)[1]
    samples = []
    for idx in squares[pick * rows:(pick + 1) * rows]:
        pos, x, cls = cook.features(pts, idx)
        samples.append(cook.subtile(pos, x, cls, idx, tr["voxel"], tr["subtile_width"]))
    b = {k: torch.from_numpy(v).to(ctx.device) for k, v in cook.pad(samples, rows).items()}
    state = g.get_state()
    classes = [int(c) for c in ctx.config["classification_dict"]]
    names = list(ctx.config["classification_dict"].values())
    out = las.read_extra(out_path, np.concatenate([s["idx"] for s in samples]),
                         names + ["entropy", "PredictedClassification"])
    one = member[np.concatenate([s["idx"] for s in samples])] == 1
    prog = {"probas": np.stack([out[n] for n in names], axis=1)[one],
            "entropy": out["entropy"][one], "classification": out["PredictedClassification"][one]}

    def reference(lower: bool) -> np.ndarray:
        """The reference's float32 logits at the compared points
        (``lower``: the control's, with TF32 products)."""
        tf32(lower)
        gen_ref = torch.Generator(device=ctx.device)
        gen_ref.set_state(state)
        net = ctx.reference.Net({k: v.clone() for k, v in w.items()}, net_cfg)
        if lower and ctx.device.type == "cpu":
            net.tf32 = True
        with torch.no_grad():
            logits = net(b["x"], b["pos"], b["mask"], gen_ref)
            full = search.interpolate(
                logits, b["sampled_pos"], b["mask"], b["full_pos"], b["full_mask"],
                ctx.config["interpolation_k"],
                search.stage_window(tr["sorted_window"], b["x"].shape[1]))
        tf32(False)
        full = full.cpu().numpy()
        return np.concatenate([full[r, :len(s["idx"])] for r, s in enumerate(samples)])[one]

    ref = reference(False)
    readings = compare.tile(prog, ref, classes)
    if not ctx.control:
        return readings, {}
    control = compare.finalized(reference(True).astype(np.float16), classes)
    return readings, compare.tile(control, ref, classes)
