"""Data of the LM's training path: the deterministic synthetic token stream
(``make_batch_specs`` of the reference belongs with the dry run, ROADMAP
Queue 1 item 11.10)."""

from repro_torch.data.tokens import TokenStream  # noqa: F401
