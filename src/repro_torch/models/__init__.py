"""The model substrate: layers, decoder LMs, the VLM and the
encoder-decoder, the registry, and the reference's weights carried
across (``weights.from_reference``)."""

from repro_torch.models import (  # noqa: F401
    common, encdec, lm, registry, vlm, weights)
