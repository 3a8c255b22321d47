"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process (``PERF.md`` gives them beside each limit):

* the program, sound, on each of ``--seeds``;
* the control, the plain reference in the precision below the
  configuration's (fp8 operands, ``reference/precision.py``), on each of
  ``--control-seeds``;
* each planted fault (``faults.py``), on each of ``--control-seeds``.

Every reading is a comparison with the float32 reference of the same seed,
which is computed once per seed.

    python3 benchmark/harness/readings.py --workload pose2vid-512.f16 \\
        --seeds 11,12,13 --control-seeds 11,12 --out chiprun_out/readings.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[2])]

from harness import check, common, faults, manifest as mf  # noqa: E402
from reference.precision import FP8  # noqa: E402


def gen_readings(cfg, traffic, seeds, control_seeds, log, device="cuda"):
    import torch

    drv = mf.driver("pose2vid")
    pipe = drv.build_program(cfg, device)
    rows = []
    for seed in seeds:
        drv.load_weights(pipe, cfg, seed, device)
        req = drv.request(cfg, traffic, seed, 0)
        t = time.perf_counter()
        runs = {"program": drv.to_uint8(drv.call(pipe, cfg, req))}
        program_s = time.perf_counter() - t
        if seed in control_seeds:
            for name in faults.GEN:
                with faults.gen_fault(name):
                    runs[name] = drv.to_uint8(drv.call(pipe, cfg, req))
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["program"]["tf32"])
        t = time.perf_counter()
        ref = drv.reference_frames(cfg, seed, req, device)
        ref_s = time.perf_counter() - t
        if seed in control_seeds:
            runs["control"] = drv.reference_frames(cfg, seed, req, device, FP8)
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["program"]["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(cfg["program"]["tf32"])
        row = {"seed": seed, "program_s": program_s, "reference_s": ref_s}
        row.update({k: {"frames_rmse": check.frames_rmse(v, ref)} for k, v in runs.items()})
        row["frame_std"] = float(ref.astype("float64").std())
        log(json.dumps(row))
        rows.append(row)
    return rows


def train_readings(cfg, traffic, seeds, control_seeds, log, device="cuda"):
    drv = mf.driver("train")
    steps = int(traffic["check_steps"])
    rows = []

    def program(seed):
        settings, modules, trainable, opt = drv.build_program(cfg, seed, device)
        pool = drv.batch_pool(cfg, traffic, seed, device, modules.clip.image_size)
        out = drv.first_steps(settings, modules, trainable, opt, pool, steps, device)
        names = list(trainable)
        del modules, trainable, opt
        common.free(device)
        return settings, pool, names, dict(
            losses=out["losses"], grad_norms=[out["grads"][n] for n in names],
            change_norms=[out["change"][n] for n in names], seconds=out["seconds"])

    for seed in seeds:
        settings, pool, names, prog = program(seed)
        runs = {"program": prog}
        if seed in control_seeds:
            for name in faults.TRAIN:
                with faults.train_fault(name):
                    runs[name] = program(seed)[3]
        t = time.perf_counter()
        ref = drv.reference_steps(cfg, settings, seed, pool, names, steps, device)
        ref_s = time.perf_counter() - t
        if seed in control_seeds:
            runs["control"] = drv.reference_steps(cfg, settings, seed, pool, names, steps,
                                                  device, FP8)
        row = {"seed": seed, "program_s": prog["seconds"], "reference_s": ref_s,
               "losses": {"program": prog["losses"], "reference": ref["losses"]}}
        row.update({k: check.train_numbers(v, ref) for k, v in runs.items()})
        log(json.dumps(row))
        rows.append(row)
        del pool
        common.free(device)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    manifest = mf.load_manifest()
    cell = mf.workload(manifest, args.workload)
    cfg, traffic = mf.config(manifest, cell["config"]), mf.traffic(cell["traffic"])
    log = lambda m: print(m, file=sys.stderr, flush=True)
    fn = gen_readings if traffic["kind"] == "pose2vid" else train_readings
    rows = fn(cfg, traffic, seeds, control, log)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
