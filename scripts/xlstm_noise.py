"""How far two equally valid computations of xLSTM-1.3B's logits differ.

    python3 scripts/xlstm_noise.py [--layers 2,8,16,32,48]

xLSTM-1.3B at published widths with chip_smoke.py's seeded random weights,
on one sequence: the serve's first prompt (173 tokens) and 32 random
tokens. For each depth cut (the first n layers, with the model's final norm
and head) and each compute dtype (bf16 on the bf16 weights, f32 on the f32
weights), the cache-less forward at the config's chunk (256) against the
same forward at chunk 64, and against a teacher-forced decode (a prefill of
the prompt into a batch-1 cache, then one recurrent decode step a token):
the largest absolute logit difference over the 32 decoded rows, beside
chip_smoke.py's ``logit_allowance(n)``. Prints one JSON line a (dtype,
depth) with the card's name and power limit. Needs a CUDA device.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", default="2,8,16,32,48",
                    help="depth cuts, comma-separated even layer counts")
    depths = [int(n) for n in ap.parse_args().layers.split(",")]
    sys.path.insert(0, str(HERE))

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    cfg = get_config("xlstm_1_3b")
    master = T.init_params(cfg, seed=cs.SEED, device="cuda")
    models = {"bf16": (T.compute_params(master, cfg), cfg),
              "f32": (master, dataclasses.replace(cfg,
                                                  compute_dtype="float32"))}
    ctx = ExecutionContext(target=H100, backend="cuda")
    _, prompts, _ = cs.serving_prompts(cfg.vocab_size)
    p = len(prompts[0])
    seq = np.concatenate([prompts[0], np.random.default_rng(5).integers(
        0, cfg.vocab_size, 32)]).astype(np.int64)

    def forward(model, c, tokens, **kw):
        return T.forward(model, c, tokens=torch.as_tensor(
            tokens[None], device="cuda"), ctx=ctx, **kw)[0][0].float()

    for dtype, (params, c) in models.items():
        for n in depths:
            cut = dataclasses.replace(c, n_layers=n)
            with torch.device("meta"):
                model = T.Transformer(cut)
            state = {k: v for k, v in params.state_dict().items()
                     if not k.startswith("layers.")
                     or int(k.split(".")[1]) < cut.repeats}
            model.load_state_dict(state, assign=True)
            with torch.inference_mode():
                base = forward(model, cut, seq)
                alt = forward(model, dataclasses.replace(cut, chunk_size=64),
                              seq)
                cache = T.init_cache(cut, 1, len(seq), device="cuda")
                rows = [forward(model, cut, seq[:p], cache=cache,
                                cache_index=0)[-1]]
                for t in range(p, len(seq) - 1):
                    rows.append(forward(model, cut, seq[t:t + 1],
                                        cache=cache, cache_index=t,
                                        decode=True)[-1])
            want = base[p - 1:len(seq) - 1]
            print(json.dumps({
                "compute": dtype, "layers": n,
                "max_abs_logit": base.abs().max().item(),
                "allowance": cs.logit_allowance(n)(base),
                "chunk64_vs_chunk256": (alt - base)[p - 1:len(seq) - 1]
                .abs().max().item(),
                "decode_vs_forward": (torch.stack(rows) - want)
                .abs().max().item(),
                "card": card}), flush=True)


if __name__ == "__main__":
    main()
