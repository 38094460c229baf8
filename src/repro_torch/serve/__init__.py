"""Serving: decode-state sizing (``kvcache``) and the prefill/decode
step functions (``serve_step``).  The engine comes with ROADMAP queue 1
item 9."""
