"""Launchers of the port: ``train`` (the train loop with checkpoints,
resume and SIGTERM), ``serve`` (the serving demo) and ``mesh`` (the
transcode mesh of the sharded path).  The elastic and dry-run launchers
come with multi-card training and the analysis modules."""
