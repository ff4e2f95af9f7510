from .icp_flow import SceneFlowEngine  # noqa: F401
