"""Single-card training: AdamW (``optimizer``), microbatch accumulation
and the int8 helpers (``grad``), the chunked-CE step (``train_step``) and
atomic sharded checkpoints in the reference's on-disk format
(``checkpoint``)."""
