"""Data: TFRecords and the COCO ETL, the record pipeline, the device
prefetcher and an in-memory dataset builder."""
