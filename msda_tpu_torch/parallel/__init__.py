"""Detection helpers; so far only the box conversion serving needs."""

from .boxes import box_cxcywh_to_xyxy

__all__ = ["box_cxcywh_to_xyxy"]
