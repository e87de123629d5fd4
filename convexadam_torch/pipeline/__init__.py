"""Registration pipelines of the port."""
