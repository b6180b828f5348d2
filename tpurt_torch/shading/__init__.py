"""Deferred shading of the clustered path."""
from tpurt_torch.shading.deferred import (HitRecords, records_oracle,
                                          shade_from_records)

__all__ = ["HitRecords", "records_oracle", "shade_from_records"]
