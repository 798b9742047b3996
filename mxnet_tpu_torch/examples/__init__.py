"""Worked examples of the port's user-facing surfaces (imported on
demand, never by ``mxnet_tpu_torch`` itself)."""
