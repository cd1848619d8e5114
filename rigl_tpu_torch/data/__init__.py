"""Input pipelines of the port: dataset loaders, batching, augmentation
and device prefetch."""
