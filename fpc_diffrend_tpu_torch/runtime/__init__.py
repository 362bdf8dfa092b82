"""The native runtime (threaded data ingestion), built at first use."""
