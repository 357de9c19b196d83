"""A/B comparison of chip_smoke.py between two trees of the repo on one card.

    python3 ab_smoke.py PARENT_DIR

PARENT_DIR holds another tree of the repo, for example the parent commit
unpacked by `git archive HEAD | tar -x -C build/parent` (build/ is
git-ignored). The script runs `python3 chip_smoke.py` four times, one after
the other: in PARENT_DIR, in this tree, in this tree again and in
PARENT_DIR again, so drift of the card or its host over the call falls on
both sides alike. Each run builds its kernels in its own tree. A run's
whole output goes to chiprun_out/ab/<n>_<side>.log. Then one JSON line per
run: its exit code and seconds, each kernel's time from its kernels line
(with the one-pass kernels' and the masked loglik's main kernel, second pass
and GRM prologue apart, the (B, K) layout and the int8 reader where it has
them; the deep
link's kernel also at the 10,240 x 1,024 shape and at widths 256, 384
and 512, its f32 kernel, row 15f, at the deep gold's shape, at config 5
and at the deep gold's shape at widths 256, 384 and 512),
the step median, device busy time and idle share of each training phase,
by link, and each probed HMC run's ms a potential evaluation and an
iteration; and last {"ok": ...}, true when all four runs exited 0.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out" / "ab"
RUN_TIMEOUT_S = 900
STEP_PHASES = ("train", "minibatch_step")
PROFILE_PHASES = ("profile", "minibatch_profile")


def summarize(stdout: str) -> dict:
    """Kernel times and phase step numbers from chip_smoke.py's JSON lines."""
    kernels, phases = {}, {}
    for line in stdout.splitlines():
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        for e in obj.get("kernels", []):
            kernels[e["name"]] = e.get("ms")
            for tag, r in (("", e), (" int8", e.get("int8_reader", {}))):
                for part in ("main_ms", "reduce_ms", "prologue_ms"):
                    if part in r:
                        kernels[f"{e['name']}{tag} {part[:-3]}"] = r[part]
            for extra, tag in (("bk_layout", "bk"), ("int8_reader", "int8"),
                               ("table_shape", "10240x1024"),
                               ("config5", "config5"),
                               ("h256", "H256"), ("h384", "H384"),
                               ("h384_wide", "H384"), ("h512", "H512")):
                if extra in e:
                    kernels[f"{e['name']} {tag}"] = e[extra].get("ms")
        phase = obj.get("phase")
        key = f"{phase} {obj.get('link', '2pl')}"
        if phase in STEP_PHASES:
            phases[key] = {"step_ms_median": obj["step_ms_median"]}
        elif phase in PROFILE_PHASES:
            phases[key] = {"device_ms_per_step": obj["device_ms_per_step"],
                           "device_idle_share": obj["device_idle_share"]}
        elif phase == "hmc" and "probe" in obj:
            phases[f"hmc {obj['path']}"] = {
                k: obj["probe"][k] for k in ("ms_per_potential_eval",
                                             "ms_per_iteration")}
    return {"kernels_ms": kernels, "phases": phases}


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    if not (parent / "chip_smoke.py").is_file():
        raise SystemExit(f"no chip_smoke.py in {parent}")
    OUT.mkdir(parents=True, exist_ok=True)
    ok = True
    for n, (side, tree) in enumerate((("parent", parent), ("change", HERE),
                                      ("change", HERE), ("parent", parent))):
        t0 = time.perf_counter()
        try:
            run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                                 capture_output=True, text=True,
                                 timeout=RUN_TIMEOUT_S)
            rc, out, err = run.returncode, run.stdout, run.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out, err = (x.decode() if isinstance(x, bytes) else x
                        for x in (out, err))
        seconds = time.perf_counter() - t0
        (OUT / f"{n}_{side}.log").write_text(
            f"{out}\n--- stderr ---\n{err}")
        ok = ok and rc == 0
        print(json.dumps({"run": n, "side": side, "rc": rc,
                          "seconds": seconds, **summarize(out)}), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
