"""Synthetic model files, host samplers, the tokenizer and tracing helpers."""
