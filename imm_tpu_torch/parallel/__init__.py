"""Multi-process helpers of the port. So far only what the file-backed
datasets need to shard their files (``distributed.shard_items``,
``distributed.process_shard_spec``); data parallelism is ROADMAP.md, Queue 1
item 10."""
