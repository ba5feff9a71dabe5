"""Adaptive refinement: request queues and the commit pipeline."""
from .refinement import AdaptationDelta, AmrQueues, commit_adaptation

__all__ = ["AdaptationDelta", "AmrQueues", "commit_adaptation"]
