from .writers import emit_gaps_bed, emit_issue_bed

__all__ = ["emit_issue_bed", "emit_gaps_bed"]
