"""Launchers of the port: ``serve`` (the serving demo) and ``mesh`` (the
transcode mesh of the sharded path).  The training, elastic and dry-run
launchers come with ROADMAP queue 1 item 11."""
