"""Data of the LM's training path: the deterministic synthetic token stream,
and one batch's meta-device stand-ins (``make_batch_specs``)."""

from repro_torch.data.tokens import TokenStream, make_batch_specs  # noqa: F401
