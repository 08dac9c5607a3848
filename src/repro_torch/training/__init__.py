"""Training for the port (``repro/training``): AdamW, the train step, int8
gradient quantization."""
