"""The data path of the port: synthetic corpora (``synthetic``), the
tokenizers (``tokenizer``) and the batched-transcode ingest pipeline
(``pipeline``)."""
