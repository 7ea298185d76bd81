"""Infra utilities: stats, tracing, logging (reference stats/, tracing/,
logger/). Every seam has a nop default so core code needs no infra — the
reference's nop-infra pattern (SURVEY.md §4.4)."""

from pilosa_tpu_torch.utils.logger import Logger, NopLogger, StandardLogger
from pilosa_tpu_torch.utils.stats import NopStatsClient, StatsClient, global_stats
from pilosa_tpu_torch.utils.tracing import NopTracer, Span, Tracer, global_tracer
