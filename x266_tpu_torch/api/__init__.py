"""Public API: Encoder / Decoder on an explicit torch device."""

from x266_tpu_torch.api.encoder import Encoder, EncodeResult  # noqa: F401
from x266_tpu_torch.api.decoder import Decoder  # noqa: F401
