"""Host-side data: the COCO reader (``coco``), robust ingest (``robust``),
masks, the training loader and the prefetcher (``loader``) and the C++
resize (``native``).  This package's ``__init__`` imports nothing, so
``coco.load_image``, the decode workers' target, imports no torch."""
