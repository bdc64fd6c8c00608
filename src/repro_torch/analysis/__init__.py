"""``repro_torch.analysis`` — the time model of the port (the counterpart of
``repro.analysis``): :mod:`.roofline`'s device constants, word/time
conversions and the dry run's cost recorder and roofline terms,
:mod:`.report`'s tables of the dry-run records, and :mod:`.timing`'s
device timer (a replayed CUDA graph)."""
