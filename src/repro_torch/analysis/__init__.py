"""``repro_torch.analysis`` — the time model of the port (the counterpart of
``repro.analysis``): :mod:`.roofline`'s device constants and word/time
conversions, and :mod:`.timing`'s device timer (a replayed CUDA graph)."""
