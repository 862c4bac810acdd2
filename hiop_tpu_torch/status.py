"""Solver status codes.

Parity with the reference's ``hiopSolveStatus`` enum
(HiOp src/Interface/hiopInterface.hpp:65-108).
"""

import enum


class SolveStatus(enum.IntEnum):
    """Outcome of a solver run."""

    # Successful termination
    Solve_Success = 0
    Solve_Success_RelTol = 1
    Solve_Acceptable_Level = 2
    Infeasible_Problem = 5
    Iterates_Diverging = 6
    Feasible_Not_Optimal = 7

    # Ran out of resources
    Max_Iter_Exceeded = 10
    Max_CpuTime_Exceeded = 11
    Time_Limit_Exceeded = 12

    # Algorithmic / numerical failures
    Steplength_Too_Small = 15
    Direction_Not_Descent = 16

    # User-requested stop
    User_Stopped = 20

    # Errors
    Invalid_Option = 30
    Invalid_Number = 31
    Error_In_User_Function = 32
    Error_In_FR = 33

    # Linear-algebra failures
    Matrix_SingularOrIllConditioned = 40
    Err_Step_Computation = 41

    # Internal
    Solve_Initialization_Error = 50
    NlpSolve_IncompleteInit = 51
    NlpSolve_SolveNotCalled = 52
    NlpSolve_Pending = 53

    Unknown = 100

    @property
    def is_success(self) -> bool:
        return self in (
            SolveStatus.Solve_Success,
            SolveStatus.Solve_Success_RelTol,
            SolveStatus.Solve_Acceptable_Level,
        )
