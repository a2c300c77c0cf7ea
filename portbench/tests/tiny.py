"""A tiny configuration and mix of the cell's shapes, for the CPU tests:
the same keys as the files under configs/ and traffic/, at widths a test
run holds. The prompt spans two prefill chunks, as the cell's does."""

FALCON = {
    "name": "falcon-tiny.q4_0", "arch": "falcon", "hidden_size": 64,
    "num_attention_heads": 4, "num_hidden_layers": 2, "vocab_size": 96,
    "multi_query": True, "ffn_hidden_size": 256, "format": "q4_0",
    "context": 128, "kv_bytes": {"element": 2, "scale": 0},
    "weights": {"d": [0.003, 0.0056], "norm_std": 0.05},
    "session": {"kv": "bf16", "n_batch": 32, "block": 4,
                "halt_on_eot": False, "ban_eot": False},
}

INTERACTIVE = {
    "driver": "session", "settings": "session", "loop": "closed",
    "clients": 1, "period": 1,
    "prompt": {"dist": "fixed", "value": 40, "min": 40, "max": 40},
    "output": {"dist": "fixed", "value": 12, "min": 12, "max": 12,
               "step": 4},
    "trace_calls": 1, "drain_cap_s": 60,
    "check": {"requests": 4, "min_tokens": 12},
}

# the generator's other distributions, as a later mix may give them
SPREAD = {
    "driver": "session", "settings": "session", "loop": "closed",
    "clients": 1, "period": 8,
    "prompt": {"dist": "lognormal", "median": 12, "sigma": 1.0, "min": 4,
               "max": 40},
    "output": {"dist": "uniform", "min": 8, "max": 24, "step": 4},
    "trace_calls": 1, "drain_cap_s": 60,
    "check": {"requests": 4, "min_tokens": 12},
}

LIMITS = {"max_logit_gap": 1e-3}
