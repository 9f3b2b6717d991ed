"""Staged ingest (counterpart of repro/ingest):

    read -> decode/augment -> cohort-stack -> device-place

One import point for the whole pipeline: the source protocol and
adapters, the stacking stage, the depth-N staging ring, device placement,
the orchestrating CohortIngestPipeline, the array-backed synthetic image
pipeline and the disk-backed dataset sources.
"""
from repro_torch.ingest.datasets import (CIFAR10Source, CIFAR100Source,
                                         DiskImageSource, TinyImageNetSource,
                                         augment_images, decode_images)
from repro_torch.ingest.images import (FederatedImageData,
                                       StreamingImageSource,
                                       build_federated_image_data,
                                       client_batches)
from repro_torch.ingest.pipeline import CohortIngestPipeline, StagedCohort
from repro_torch.ingest.placement import CohortPlacer
from repro_torch.ingest.prefetch import CohortPrefetcher
from repro_torch.ingest.sources import (DataSource, IteratorDataSource,
                                        ListDataSource, as_data_source)
from repro_torch.ingest.stack import (stack_batches, stack_cohort,
                                      stack_cohort_into)

__all__ = [
    "CIFAR10Source", "CIFAR100Source", "DiskImageSource",
    "TinyImageNetSource", "augment_images", "decode_images",
    "FederatedImageData", "StreamingImageSource",
    "build_federated_image_data", "client_batches",
    "CohortIngestPipeline", "StagedCohort", "CohortPlacer",
    "CohortPrefetcher",
    "DataSource", "IteratorDataSource", "ListDataSource", "as_data_source",
    "stack_batches", "stack_cohort", "stack_cohort_into",
]
