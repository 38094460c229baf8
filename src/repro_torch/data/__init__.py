"""The data path of the port: synthetic corpora (``synthetic``), the
tokenizers (``tokenizer``), the batched-transcode ingest pipeline
(``pipeline``) and the double-buffered feeder of the sharded path
(``shard_feed``)."""
