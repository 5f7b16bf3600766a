"""Reference-guided inference of the port (counterpart of msig_tpu/infer)."""
