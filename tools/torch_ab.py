"""Compare two trees of the PyTorch port on one GPU, in one process each,
in the order parent, change, change, parent:

    python3 tools/torch_ab.py <parent root> <change root>

Each process builds its tree's kernels, answers three CamContextI2V-256
requests at batch 1 (`sample`, the 25-step recipe) and takes nine batch-2
training micro-steps of `make_train_step` (the flagship recipe), and prints
one line `AB {json}` with the wall and host CPU seconds of each request and
micro-step. Seeded random weights, as in chip_smoke.py.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def one(root: str, label: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from camc2v_tpu_torch import presets
    from camc2v_tpu_torch.ops import _build
    from camc2v_tpu_torch.parallel import trainer as TR

    dev = torch.device("cuda:0")
    _build.build_all()

    def timed(fn):
        torch.cuda.synchronize()
        w, c = time.perf_counter(), time.process_time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - w, time.process_time() - c

    res = {"label": label, "root": root}
    model = presets.build("camcontexti2v_256", seed=4321)
    gen = []
    for seed in (11, 12, 13):
        batch = cs.camcontext_batch(model, 1, seed, dev)
        with torch.no_grad():
            _, wall, cpu = timed(lambda: model.sample(batch))
        gen.append((wall, cpu))
    res["request_b1_wall_s"], res["request_b1_cpu_s"] = [w for w, _ in gen], [c for _, c in gen]
    del model
    torch.cuda.empty_cache()
    cfg = presets.camcontexti2v_256_train()
    model = presets.build_for_training("camcontexti2v_256", seed=4321)
    state = TR.init_train_state(cfg, model)
    step = TR.make_train_step(model, cfg)
    batch = cs.camcontext_batch(model, 2, 100, dev)
    steps = [timed(lambda: step(state, batch, 0)) for _ in range(9)]
    res["micro_step_b2_wall_s"] = [w for _, w, _ in steps]
    res["micro_step_b2_cpu_s"] = [c for _, _, c in steps]
    res["micro_step_b2_median_after_first_s"] = statistics.median(res["micro_step_b2_wall_s"][1:])
    res["loss_last"] = float(steps[-1][0]["loss"])
    return res


def main() -> None:
    if sys.argv[1] == "--one":
        print("AB " + json.dumps(one(sys.argv[2], sys.argv[3])), flush=True)
        return
    parent, change = sys.argv[1], sys.argv[2]
    for root, label in ((parent, "parent"), (change, "change"), (change, "change"), (parent, "parent")):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, label], check=True)


if __name__ == "__main__":
    main()
