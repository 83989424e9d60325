from .base import Input, InputState, RingBuffer, input_new

__all__ = ["Input", "InputState", "RingBuffer", "input_new"]
