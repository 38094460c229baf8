"""Launchers of the port: ``serve`` (the serving demo).  The training,
elastic, mesh and dry-run launchers come with ROADMAP queue 1 items 10
and 11."""
