"""Persistence and tracing (the reference's utils/; its logger is
config.get_logger)."""
