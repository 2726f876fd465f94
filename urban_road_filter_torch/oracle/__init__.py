from urban_road_filter_torch.oracle.reference import OracleResult, run_oracle

__all__ = ["OracleResult", "run_oracle"]
