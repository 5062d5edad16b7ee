"""Data ingestion of the port: the streamed fold."""
