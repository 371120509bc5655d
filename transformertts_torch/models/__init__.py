"""Models: the ForwardTransformer (synthesis) and its serving path."""
from transformertts_torch.models.forward_tts import ForwardTransformer

__all__ = ['ForwardTransformer']
